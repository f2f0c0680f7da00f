"""The twin-trunk kernels' wrappers, their plain PyTorch versions, and the
autograd Function that pairs them.

:func:`twin_trunks` runs both CNNPolicy feature trunks (conv1 -> ReLU ->
conv2 -> ReLU -> channel-major flatten -> fc1 -> ReLU) on (B, F, NB) scans
and returns the (2, B, 256) actor and critic features.  On CUDA tensors it
launches the hand-written kernel in ``csrc/trunk_fwd.cu`` (which replaces
``rl_collision_avoidance_tpu/ops/trunk_pallas.py::_fwd_kernel``); on CPU
tensors it runs :func:`twin_trunks_plain`.  :func:`twin_trunks_grads` is the
backward: the twelve weight gradients from the feature cotangent, launched
from ``csrc/trunk_bwd.cu`` (which replaces ``trunk_pallas.py::_bwd_kernel``)
or, on CPU tensors, :func:`twin_trunks_grads_plain`.  Each has two
modes, ``precision="float32"`` and ``precision="bf16"``: the JAX kernels'
``TrunkConfig(precision="default", out_dtype="bfloat16")``, where every
product operand (scans, weights, activations, cotangents) is rounded to
bf16 and the products accumulate in float32, the features come out as bf16
and the cotangent comes in as bf16; the weights and their gradients stay
float32.  The scans may be float32 or bf16 in either mode.  Both kernels are a
conv pass and products on one shared core, per mode: float32 on the FFMA
path, bf16 on the tensor cores; :func:`plan` says how they cut a batch
(conv blocks, split-K ranges) and sizes their workspace, which the wrappers
allocate.  There is no fallback between kernel and plain version, nor
between the modes.  Where autograd needs the weights'
gradients, :func:`twin_trunks` goes through :class:`TwinTrunks`, which pairs
the two; like the JAX package's custom_vjp, it gives no gradient to the
scans.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import build

#: Forward-kernel launches since the count was last set to 0.
launches = 0
#: Backward-kernel launches since the count was last set to 0.
bwd_launches = 0
#: Launches of either kernel by (kernel name, batch B, precision), cleared
#: with the counts.
launches_by_mode: collections.Counter = collections.Counter()
#: Bytes of the workspace tensor each kernel's last launch allocated, by
#: (kernel name, batch B, precision).
workspace_bytes: dict = {}

#: The kernels' modes, and the dtype of the features each gives.
PRECISIONS = {"float32": torch.float32, "bf16": torch.bfloat16}

#: Per trunk, in this order: conv1 weight (32, F, 5) and bias, conv2 weight
#: (32, 32, 3) and bias, fc1 weight (256, 32 * L2) and bias.
WEIGHT_NAMES = ("w1", "b1", "w2", "b2", "wf", "bf")


@contextlib.contextmanager
def exact_float32():
    """Full float32 in cuDNN convolutions and cuBLAS products (no TF32),
    restoring the previous settings on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: the trunk kernels take "
                         f"{', '.join(map(repr, PRECISIONS))}")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16 (ties to even), in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class _Round(torch.autograd.Function):
    """A product operand in bf16 mode: rounded to bf16 going forward; the
    gradient passes unchanged (to the float32 weights, and to the
    activation behind the operand, as the JAX kernel's gradients do)."""

    @staticmethod
    def forward(ctx, x):
        return round_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundCotangent(torch.autograd.Function):
    """The identity going forward; going back, the cotangent rounded to
    bf16, as the JAX kernel rounds g1, g2 and g3 where they enter the
    products of the weight gradients and the transposed convs (its bias
    gradients sum them unrounded, so this stands between a product and its
    bias add)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_bf16(g)


def trunk_plain(scans, w1, b1, w2, b2, wf, bf,
                precision: str = "float32") -> torch.Tensor:
    """One trunk, plain version: (B, F, NB) -> (B, 256), in the weights'
    dtype (float32; float64 for a reference).  bf16 mode: every product
    operand rounded to bf16 (exact products), float32 sums, bias adds and
    ReLUs, the cotangents rounded on the way back, and, in float32, the
    features rounded to bf16; the same function on the CPU and the card."""
    x = scans.to(w1.dtype)
    with exact_float32():
        if precision == "float32":
            y = F.relu(F.conv1d(x, w1, b1, stride=2, padding=1))
            y = F.relu(F.conv1d(y, w2, b2, stride=2, padding=1))
            return F.relu(F.linear(y.flatten(1), wf, bf))
        r, rc = _Round.apply, _RoundCotangent.apply
        y = F.relu(rc(F.conv1d(r(x), r(w1), stride=2, padding=1))
                   + b1[:, None])
        y = F.relu(rc(F.conv1d(r(y), r(w2), stride=2, padding=1))
                   + b2[:, None])
        y = F.relu(rc(F.linear(r(y.flatten(1)), r(wf))) + bf)
    return y.to(torch.bfloat16) if y.dtype == torch.float32 else y


def twin_trunks_plain(scans, act, crt,
                      precision: str = "float32") -> torch.Tensor:
    """Plain version of :func:`twin_trunks`."""
    check_precision(precision)
    return torch.stack([trunk_plain(scans, *act, precision=precision),
                        trunk_plain(scans, *crt, precision=precision)])


def twin_trunks_grads_plain(scans, act, crt, g,
                            precision: str = "float32") -> tuple[tuple, tuple]:
    """Plain version of :func:`twin_trunks_grads`: autograd through
    :func:`twin_trunks_plain`, in exact float32 (or the weights' float64)."""
    with torch.enable_grad(), exact_float32():
        ws = [w.detach().requires_grad_() for w in (*act, *crt)]
        out = twin_trunks_plain(scans.detach(), ws[:6], ws[6:], precision)
        grads = torch.autograd.grad(out, ws, g.to(out.dtype))
    return tuple(grads[:6]), tuple(grads[6:])


#: Constants of the kernels' launch plan, as ``csrc/trunk_gemm.cuh``,
#: ``csrc/trunk_mma.cuh`` and ``csrc/trunk_conv.cuh`` define them: the
#: product cores' 128 x 128 block tile and their k tiles (16 deep on the
#: float32 FFMA core, 32 on the bf16 tensor-core core), the forward conv
#: pass's two samples per step, the frames and beam counts the kernels take.
GEMM_TILE, GEMM_K_TILE = 128, 16
K_TILES = {"float32": GEMM_K_TILE, "bf16": 32}
FWD_GROUP = 2
MAX_FRAMES = 6
MAX_SPLITS = 16
#: bf16 mode: the row ranges of g1 whose sums dbf adds
#: (``csrc/trunk_bwd.cu::kBiasRanges``).
BIAS_RANGES = 64
#: Blocks of the product core and of the conv passes that fit on one SM.
BLOCKS_PER_SM = 2
#: The SM count the plan assumes when it is not given one (an H100 SXM).
H100_SMS = 132


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def split(n: int, parts: int) -> tuple[int, int]:
    """``n`` items in at most ``parts`` ranges of ``chunk`` items: range i is
    [i * chunk, min((i + 1) * chunk, n)).  Returns (chunk, ranges), with
    ranges chosen so that none is empty; the kernels cut the same way."""
    chunk = ceil_div(n, parts)
    return chunk, ceil_div(n, chunk)


def ranges(n: int, chunk: int) -> list[tuple[int, int]]:
    """The ranges :func:`split` describes."""
    return [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]


def conv_ranges(batch: int, blocks: int) -> list[tuple[int, int]]:
    """The samples of each of ``blocks`` conv blocks, as the kernels cut
    them (``csrc/trunk_conv.cuh::block_samples``): block i takes groups
    [i G / blocks, (i + 1) G / blocks) of the G = ceil(batch / FWD_GROUP)
    groups of FWD_GROUP samples, so ranges differ by at most one group."""
    groups = ceil_div(batch, FWD_GROUP)
    return [(i * groups // blocks * FWD_GROUP,
             min(batch, (i + 1) * groups // blocks * FWD_GROUP))
            for i in range(blocks)]


def _fill(blocks: int, slots: int) -> float:
    """Share of the block slots that ``blocks`` keep busy over its waves."""
    return blocks / (ceil_div(blocks, slots) * slots)


def k_splits(tiles: int, ktiles: int, slots: int) -> int:
    """Split-K ranges for a product of ``tiles`` output tiles (both trunks)
    and ``ktiles`` k tiles: the fewest whose waves fill at least 90% as well
    as the best count up to :data:`MAX_SPLITS`."""
    counts = range(1, min(MAX_SPLITS, ktiles) + 1)
    best = max(_fill(tiles * s, slots) for s in counts)
    s = next(s for s in counts if _fill(tiles * s, slots) >= 0.9 * best)
    return split(ktiles, s)[1]


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the trunk kernels cut a batch of ``batch`` samples of (frames,
    beams) scans: conv blocks per trunk, split-K ranges of fc1 (forward and
    its recompute in the backward) and of dWf, and the workspace each kernel
    needs, in floats, in the mode ``precision``."""
    batch: int
    frames: int
    beams: int
    conv_blocks: int
    fc1_splits: int
    dwf_splits: int
    precision: str = "float32"

    @property
    def nflat(self) -> int:
        return _weight_shapes(self.frames, self.beams)["wf"][1]

    @property
    def l2(self) -> int:
        """conv2 positions: columns of one channel in the flat features."""
        return self.nflat // 32

    @property
    def k_tile(self) -> int:
        """The product core's k tile in this mode."""
        return K_TILES[self.precision]

    @property
    def fc1_kchunk(self) -> int:
        """k tiles per fc1 split range (K = nflat)."""
        return ceil_div(ceil_div(self.nflat, self.k_tile), self.fc1_splits)

    @property
    def dwf_kchunk(self) -> int:
        """k tiles per dWf split range (K = the batch)."""
        return ceil_div(ceil_div(self.batch, self.k_tile), self.dwf_splits)

    def products(self) -> dict[str, tuple[int, int, int, int, int]]:
        """(M, N, K, splits, k tiles per split) of each product, as the
        kernels launch them: the grid is (N tiles, M tiles, 2 x splits) and
        split s sums k tiles [s chunk, (s + 1) chunk)."""
        b, nflat = self.batch, self.nflat
        return {"fc1": (b, 256, nflat, self.fc1_splits, self.fc1_kchunk),
                "g1": (b, 256, nflat, self.fc1_splits, self.fc1_kchunk),
                "dWf": (256, nflat, b, self.dwf_splits, self.dwf_kchunk),
                "dflat": (b, nflat, 256, 1, 256 // self.k_tile)}

    def _part(self, m: int, n: int, splits: int) -> int:
        return 2 * splits * m * n if splits > 1 else 0

    def fwd_regions(self) -> dict[str, tuple[int, int]]:
        """(offset, floats) of each part of the forward's workspace: the flat
        features (2, B, nflat), float32 or (bf16 mode) bf16; in bf16 mode
        the fc1 weight (2, 256, nflat) as bf16; then fc1's split-K
        partials."""
        b, nflat = self.batch, self.nflat
        part = self._part(b, 256, self.fc1_splits)
        if self.precision == "bf16":
            return _packed((("flat", b * nflat), ("wf16", 256 * nflat),
                            ("fc1_part", part)))
        return _packed((("flat", 2 * b * nflat), ("fc1_part", part)))

    def bwd_regions(self) -> dict[str, tuple[int, int]]:
        """(offset, floats) of each part of the backward's workspace: the
        flat features (g2 later), g1, the conv blocks' partials, and the
        split-K partials of fc1's recompute and of dWf, which share a
        region.  In bf16 mode the flat features and g1 are bf16 (half the
        floats), and the bf16 fc1 weight (2, 256, nflat), dflat's column
        sums for db2 (2, M tiles, nflat) and dbf's sums over BIAS_RANGES
        row ranges of g1 join them."""
        b, nflat = self.batch, self.nflat
        psize = 32 * self.frames * 5 + 32 + 32 * 32 * 3 + 32
        k_part = max(self._part(b, 256, self.fc1_splits),
                     self._part(256, nflat, self.dwf_splits))
        conv_part = 2 * self.conv_blocks * psize
        if self.precision == "bf16":
            mtiles = ceil_div(b, GEMM_TILE)
            return _packed((("flat", b * nflat), ("g1", b * 256),
                            ("wf16", 256 * nflat), ("conv_part", conv_part),
                            ("db2_part", 2 * mtiles * nflat),
                            ("bias_part", 2 * BIAS_RANGES * 256),
                            ("k_part", k_part)))
        return _packed((("flat", 2 * b * nflat), ("g1", 2 * b * 256),
                        ("conv_part", conv_part), ("k_part", k_part)))

    @property
    def fwd_workspace(self) -> int:
        return sum(self.fwd_regions()["fc1_part"])

    @property
    def bwd_workspace(self) -> int:
        return sum(self.bwd_regions()["k_part"])


def _packed(sizes) -> dict[str, tuple[int, int]]:
    """(offset, floats) of regions laid out back to back in this order."""
    out, at = {}, 0
    for name, n in sizes:
        out[name] = (at, n)
        at += n
    return out


def plan(batch: int, frames: int, beams: int, sms: int = H100_SMS,
         precision: str = "float32") -> Plan:
    """The launch plan for ``batch`` samples on a card with ``sms`` SMs: the
    conv passes give each trunk ``sms`` blocks, or one a sample group where
    there are fewer groups (two trunks, two blocks an SM: one wave), and
    the products split K (in the mode's k tiles) where their tiles alone
    would fill the card's block slots poorly."""
    nflat = _weight_shapes(frames, beams)["wf"][1]
    slots = BLOCKS_PER_SM * sms
    k_tile = K_TILES[precision]
    fc1 = k_splits(2 * ceil_div(batch, GEMM_TILE) * ceil_div(256, GEMM_TILE),
                   ceil_div(nflat, k_tile), slots)
    dwf = k_splits(2 * ceil_div(256, GEMM_TILE) * ceil_div(nflat, GEMM_TILE),
                   ceil_div(batch, k_tile), slots)
    return Plan(batch, frames, beams, min(ceil_div(batch, FWD_GROUP), sms),
                fc1, dwf, precision)


def plan_for(scans: torch.Tensor, precision: str = "float32") -> Plan:
    """The plan for these (B, F, NB) scans on their card (an H100's SM count
    for CPU tensors)."""
    sms = (_sm_count(scans.device.index or 0) if scans.is_cuda
           else H100_SMS)
    return plan(*scans.shape, sms, precision)


def kernel_shapes_ok(frames: int, beams: int) -> bool:
    """The scan shapes the trunk kernels take: 1 to :data:`MAX_FRAMES`
    frames and a beam count that is a positive multiple of 16."""
    return 1 <= frames <= MAX_FRAMES and beams >= 16 and beams % 16 == 0


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = build.library()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd = lib.trunk_fwd_launch
    fwd.argtypes = [p, ctypes.POINTER(ctypes.c_void_p), p, p, ll, i, i, i, i,
                    i, i, i, i, p]
    fwd.restype = ctypes.c_int
    bwd = lib.trunk_bwd_launch
    bwd.argtypes = [p, ctypes.POINTER(ctypes.c_void_p), p, p, p, ll, i, i, i,
                    i, i, i, i, i, i, p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def workspace_counters():
    """The kernels' own workspace counts, ``trunk_fwd_workspace_floats(B,
    F, NB, fc1_splits, bf16_mode)`` and ``trunk_bwd_workspace_floats(B, F,
    NB, conv_blocks, fc1_splits, dwf_splits, bf16_mode)``: what the
    launchers hold the wrapper's workspace to."""
    lib = build.library()
    i = ctypes.c_int
    fwd, bwd = lib.trunk_fwd_workspace_floats, lib.trunk_bwd_workspace_floats
    fwd.argtypes, fwd.restype = [i] * 5, ctypes.c_longlong
    bwd.argtypes, bwd.restype = [i] * 7, ctypes.c_longlong
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _require(cond: bool, what: str, msg) -> None:
    """Raise ValueError with ``msg()`` when ``cond`` fails; the message is
    built only then."""
    if not cond:
        raise ValueError(f"{what}: {msg()}")


def _weight_shapes(frames: int, beams: int) -> dict:
    l1 = (beams - 3) // 2 + 1
    l2 = (l1 - 1) // 2 + 1
    return {"w1": (32, frames, 5), "b1": (32,), "w2": (32, 32, 3),
            "b2": (32,), "wf": (256, 32 * l2), "bf": (256,)}


def _check_cuda(what: str, scans, weights, extra=()) -> dict:
    """What both kernels need of their inputs: float32 or bf16 scans,
    float32 weights, and ``extra`` tensors of their own checked dtype;
    returns the weight shapes."""
    _require(scans.is_cuda, what,
             lambda: f"unsupported device {scans.device}")
    _require(scans.dtype in (torch.float32, torch.bfloat16), what,
             lambda: f"scans must be float32 or bf16, not {scans.dtype}")
    _require(scans.dim() == 3, what,
             lambda: f"scans has shape {tuple(scans.shape)}")
    _require(kernel_shapes_ok(*scans.shape[1:]), what,
             lambda: f"scans of {scans.shape[1]} frames x {scans.shape[2]} "
             f"beams; the kernels take 1 to {MAX_FRAMES} frames and a "
             f"multiple of 16 beams")
    shapes = _weight_shapes(*scans.shape[1:])
    _require(len(weights) == 12, what, lambda: "needs six weights per trunk")
    for name, t in zip(WEIGHT_NAMES * 2, weights):
        _require(t.shape == shapes[name], what, lambda: f"{name} has shape "
                 f"{tuple(t.shape)}, wants {shapes[name]}")
    for t in weights:
        _require(t.dtype == torch.float32, what,
                 lambda: f"weights must be float32, not {t.dtype}")
    for t in [scans, *weights, *extra]:
        _require(t.device == scans.device, what,
                 lambda: f"a tensor is on {t.device}, scans on {scans.device}")
        _require(t.is_contiguous(), what, lambda: "tensors must be contiguous")
        _require(t.data_ptr() % 16 == 0, what,
                 lambda: "tensors must start on a 16-byte boundary")
    return shapes


def _kernel_forward(scans, weights, precision: str) -> torch.Tensor:
    check_precision(precision)
    _check_cuda("twin_trunks", scans, weights)
    b, frames, beams = scans.shape
    out = torch.empty((2, b, 256), dtype=PRECISIONS[precision],
                      device=scans.device)
    if b == 0:
        return out
    index = scans.device.index or 0
    pl = plan_for(scans, precision)
    work = torch.empty(pl.fwd_workspace, dtype=torch.float32,
                       device=scans.device)
    ptrs = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in weights))
    stream = torch.cuda.current_stream(scans.device).cuda_stream
    status = _launchers()[0](scans.data_ptr(), ptrs, out.data_ptr(),
                             work.data_ptr(), work.numel(), b, frames, beams,
                             pl.conv_blocks, pl.fc1_splits,
                             scans.dtype == torch.bfloat16,
                             precision == "bf16", index, stream)
    build.check(status, "twin_trunks")
    global launches
    launches += 1
    launches_by_mode["twin_trunks", b, precision] += 1
    workspace_bytes["twin_trunks", b, precision] = work.nbytes
    return out


class TwinTrunks(torch.autograd.Function):
    """``apply(scans, *act, *crt[, precision])`` -> (2, B, 256) features;
    the forward and backward kernels on CUDA, the plain versions on the CPU,
    in the mode ``precision`` (float32 when not given).  Saves the scans and
    weights and recomputes the activations in the backward, as the JAX
    custom_vjp does; in bf16 mode the cotangent arrives as bf16 and goes to
    the backward kernel as it is.  The scans get no gradient: it raises if
    they need one rather than return a silent zero."""

    @staticmethod
    def forward(ctx, scans, *args):
        if ctx.needs_input_grad[0]:
            raise RuntimeError("TwinTrunks: the trunk kernels give no "
                               "gradient to the scans; detach them")
        ctx.named = isinstance(args[-1], str)
        weights = args[:-1] if ctx.named else args
        ctx.precision = args[-1] if ctx.named else "float32"
        ctx.save_for_backward(scans, *weights)
        if scans.device.type == "cpu":
            return twin_trunks_plain(scans, weights[:6], weights[6:],
                                     ctx.precision)
        return _kernel_forward(scans, weights, ctx.precision)

    @staticmethod
    def backward(ctx, g):
        scans, *weights = ctx.saved_tensors
        with span("twin_trunks_grads"):
            act, crt = twin_trunks_grads(scans, weights[:6], weights[6:],
                                         g.contiguous(), ctx.precision)
        return (None, *act, *crt) + ((None,) if ctx.named else ())


def twin_trunks(scans, act, crt, precision: str = "float32") -> torch.Tensor:
    """(B, F, NB) scans (float32 or bf16) and the actor and critic trunk
    weights (each a sequence in :data:`WEIGHT_NAMES` order) -> (2, B, 256)
    features, float32 or, with ``precision="bf16"``, bf16.  Differentiable
    in the weights (through :class:`TwinTrunks`), not in the scans."""
    weights = [*act, *crt]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in [scans, *weights]):
        return TwinTrunks.apply(scans, *weights, precision)
    if scans.device.type == "cpu":
        return twin_trunks_plain(scans, act, crt, precision)
    return _kernel_forward(scans, weights, precision)


def twin_trunks_grads(scans, act, crt, g,
                      precision: str = "float32") -> tuple[tuple, tuple]:
    """The gradients of ``sum(g * twin_trunks(scans, act, crt, precision))``
    with respect to the actor and the critic trunk weights, as two tuples in
    :data:`WEIGHT_NAMES` order, float32; ``g`` is (2, B, 256) of the
    features' dtype."""
    if scans.device.type == "cpu":
        return twin_trunks_grads_plain(scans, act, crt, g, precision)
    return _kernel_grads(scans, [*act, *crt], g, precision)


def _kernel_grads(scans, weights, g, precision: str) -> tuple[tuple, tuple]:
    check_precision(precision)
    shapes = _check_cuda("twin_trunks_grads", scans, weights, (g,))
    b, frames, beams = scans.shape
    _require(g.shape == (2, b, 256), "twin_trunks_grads",
             lambda: f"g has shape {tuple(g.shape)}, wants {(2, b, 256)}")
    _require(g.dtype == PRECISIONS[precision], "twin_trunks_grads",
             lambda: f"g is {g.dtype}; the {precision} mode takes a "
             f"{PRECISIONS[precision]} cotangent")
    sizes = [torch.Size(shapes[n]).numel() for n in WEIGHT_NAMES]
    grads = torch.empty((2, sum(sizes)), dtype=torch.float32,
                        device=scans.device)
    if b == 0:
        grads.zero_()
    else:
        index = scans.device.index or 0
        pl = plan_for(scans, precision)
        work = torch.empty(pl.bwd_workspace, dtype=torch.float32,
                           device=scans.device)
        ptrs = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in weights))
        stream = torch.cuda.current_stream(scans.device).cuda_stream
        status = _launchers()[1](
            scans.data_ptr(), ptrs, g.data_ptr(), grads.data_ptr(),
            work.data_ptr(), work.numel(), b, frames, beams,
            pl.conv_blocks, pl.fc1_splits, pl.dwf_splits,
            scans.dtype == torch.bfloat16, precision == "bf16", index, stream)
        build.check(status, "twin_trunks_grads")
        global bwd_launches
        bwd_launches += 1
        launches_by_mode["twin_trunks_grads", b, precision] += 1
        workspace_bytes["twin_trunks_grads", b, precision] = work.nbytes
    act, crt = (tuple(part.view(shapes[n]) for part, n in
                      zip(row.split(sizes), WEIGHT_NAMES)) for row in grads)
    return act, crt
