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
or, on CPU tensors, :func:`twin_trunks_grads_plain`.  There is no fallback
between kernel and plain version.  Where autograd needs the weights'
gradients, :func:`twin_trunks` goes through :class:`TwinTrunks`, which pairs
the two; like the JAX package's custom_vjp, it gives no gradient to the
scans.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from . import build

#: Forward-kernel launches since the count was last set to 0.
launches = 0
#: The same launches by batch size B, cleared with the count.
launches_by_batch: collections.Counter = collections.Counter()
#: Backward-kernel launches since the count was last set to 0.
bwd_launches = 0

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


def trunk_plain(scans, w1, b1, w2, b2, wf, bf) -> torch.Tensor:
    """One trunk, plain version: (B, F, NB) -> (B, 256)."""
    with exact_float32():
        y = F.relu(F.conv1d(scans, w1, b1, stride=2, padding=1))
        y = F.relu(F.conv1d(y, w2, b2, stride=2, padding=1))
        return F.relu(F.linear(y.flatten(1), wf, bf))


def twin_trunks_plain(scans, act, crt) -> torch.Tensor:
    """Plain version of :func:`twin_trunks`."""
    return torch.stack([trunk_plain(scans, *act), trunk_plain(scans, *crt)])


def twin_trunks_grads_plain(scans, act, crt, g) -> tuple[tuple, tuple]:
    """Plain version of :func:`twin_trunks_grads`: autograd through
    :func:`twin_trunks_plain`, in exact float32."""
    with torch.enable_grad(), exact_float32():
        ws = [w.detach().requires_grad_() for w in (*act, *crt)]
        out = twin_trunks_plain(scans.detach(), ws[:6], ws[6:])
        grads = torch.autograd.grad(out, ws, g)
    return tuple(grads[:6]), tuple(grads[6:])


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = build.library()
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd = lib.trunk_fwd_launch
    fwd.argtypes = [p, ctypes.POINTER(ctypes.c_void_p), p, i, i, i, i, p]
    fwd.restype = ctypes.c_int
    bwd = lib.trunk_bwd_launch
    bwd.argtypes = [p, ctypes.POINTER(ctypes.c_void_p), p, p, p, i, i, i, i,
                    p]
    bwd.restype = ctypes.c_int
    work = lib.trunk_bwd_workspace_floats
    work.argtypes, work.restype = [i, i, i], ctypes.c_longlong
    return fwd, bwd, work


def _require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _weight_shapes(frames: int, beams: int) -> dict:
    l1 = (beams - 3) // 2 + 1
    l2 = (l1 - 1) // 2 + 1
    return {"w1": (32, frames, 5), "b1": (32,), "w2": (32, 32, 3),
            "b2": (32,), "wf": (256, 32 * l2), "bf": (256,)}


def _check_cuda(what: str, scans, weights, extra=()) -> dict:
    """What both kernels need of their inputs; returns the weight shapes."""
    _require(scans.is_cuda, what, f"unsupported device {scans.device}")
    _require(scans.dim() == 3, what, f"scans has shape {tuple(scans.shape)}")
    shapes = _weight_shapes(*scans.shape[1:])
    _require(len(weights) == 12, what, "needs six weights per trunk")
    for name, t in zip(WEIGHT_NAMES * 2, weights):
        _require(tuple(t.shape) == shapes[name], what,
                 f"{name} has shape {tuple(t.shape)}, wants {shapes[name]}")
    for t in [scans, *weights, *extra]:
        _require(t.device == scans.device, what, f"a tensor is on "
                 f"{t.device}, scans on {scans.device}")
        _require(t.dtype == torch.float32, what, "tensors must be float32")
        _require(t.is_contiguous(), what, "tensors must be contiguous")
    return shapes


def _kernel_forward(scans, weights) -> torch.Tensor:
    _check_cuda("twin_trunks", scans, weights)
    b, frames, beams = scans.shape
    out = torch.empty((2, b, 256), dtype=torch.float32, device=scans.device)
    if b == 0:
        return out
    ptrs = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in weights))
    stream = torch.cuda.current_stream(scans.device).cuda_stream
    status = _launchers()[0](scans.data_ptr(), ptrs, out.data_ptr(), b,
                             frames, beams, scans.device.index or 0, stream)
    build.check(status, "twin_trunks")
    global launches
    launches += 1
    launches_by_batch[b] += 1
    return out


class TwinTrunks(torch.autograd.Function):
    """``apply(scans, *act, *crt)`` -> (2, B, 256) features; the forward and
    backward kernels on CUDA, the plain versions on the CPU.  Saves the scans
    and weights and recomputes the activations in the backward, as the JAX
    custom_vjp does.  The scans get no gradient: it raises if they need one
    rather than return a silent zero."""

    @staticmethod
    def forward(ctx, scans, *weights):
        if ctx.needs_input_grad[0]:
            raise RuntimeError("TwinTrunks: the trunk kernels give no "
                               "gradient to the scans; detach them")
        ctx.save_for_backward(scans, *weights)
        if scans.device.type == "cpu":
            return twin_trunks_plain(scans, weights[:6], weights[6:])
        return _kernel_forward(scans, weights)

    @staticmethod
    def backward(ctx, g):
        scans, *weights = ctx.saved_tensors
        with record_function("twin_trunks_grads"):
            act, crt = twin_trunks_grads(scans, weights[:6], weights[6:],
                                         g.contiguous())
        return (None, *act, *crt)


def twin_trunks(scans, act, crt) -> torch.Tensor:
    """(B, F, NB) scans and the actor and critic trunk weights (each a
    sequence in :data:`WEIGHT_NAMES` order) -> (2, B, 256) features.
    Differentiable in the weights (through :class:`TwinTrunks`), not in the
    scans."""
    weights = [*act, *crt]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in [scans, *weights]):
        return TwinTrunks.apply(scans, *weights)
    if scans.device.type == "cpu":
        return twin_trunks_plain(scans, act, crt)
    return _kernel_forward(scans, weights)


def twin_trunks_grads(scans, act, crt, g) -> tuple[tuple, tuple]:
    """The gradients of ``sum(g * twin_trunks(scans, act, crt))`` with respect
    to the actor and the critic trunk weights, as two tuples in
    :data:`WEIGHT_NAMES` order; ``g`` is (2, B, 256)."""
    if scans.device.type == "cpu":
        return twin_trunks_grads_plain(scans, act, crt, g)
    return _kernel_grads(scans, [*act, *crt], g)


def _kernel_grads(scans, weights, g) -> tuple[tuple, tuple]:
    shapes = _check_cuda("twin_trunks_grads", scans, weights, (g,))
    b, frames, beams = scans.shape
    _require(tuple(g.shape) == (2, b, 256), "twin_trunks_grads",
             f"g has shape {tuple(g.shape)}, wants {(2, b, 256)}")
    sizes = [torch.Size(shapes[n]).numel() for n in WEIGHT_NAMES]
    grads = torch.empty((2, sum(sizes)), dtype=torch.float32,
                        device=scans.device)
    if b == 0:
        grads.zero_()
    else:
        _, launch, work_floats = _launchers()
        work = torch.empty(work_floats(b, frames, beams), dtype=torch.float32,
                           device=scans.device)
        ptrs = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in weights))
        stream = torch.cuda.current_stream(scans.device).cuda_stream
        status = launch(scans.data_ptr(), ptrs, g.data_ptr(),
                        grads.data_ptr(), work.data_ptr(), b, frames, beams,
                        scans.device.index or 0, stream)
        # the kernel refuses more frames than it keeps sums for (kMaxFrames)
        build.check(status, f"twin_trunks_grads ({frames} frames)")
        global bwd_launches
        bwd_launches += 1
    act, crt = (tuple(part.view(shapes[n]) for part, n in
                      zip(row.split(sizes), WEIGHT_NAMES)) for row in grads)
    return act, crt
