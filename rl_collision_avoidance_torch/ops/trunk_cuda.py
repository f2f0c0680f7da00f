"""The twin-trunk forward kernel's wrapper and its plain PyTorch version.

:func:`twin_trunks` runs both CNNPolicy feature trunks (conv1 -> ReLU ->
conv2 -> ReLU -> channel-major flatten -> fc1 -> ReLU) on (B, F, NB) scans
and returns the (2, B, 256) actor and critic features.  On CUDA tensors it
launches the hand-written kernel in ``csrc/trunk_fwd.cu`` (which replaces
``rl_collision_avoidance_tpu/ops/trunk_pallas.py::_fwd_kernel``); on CPU
tensors it runs :func:`twin_trunks_plain`.  There is no fallback between
the two.  The kernel has no backward yet, so on CUDA it refuses to run
where autograd would need one.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

#: Kernel launches since the count was last set to 0.
launches = 0

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


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library().trunk_fwd_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.POINTER(ctypes.c_void_p), p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"twin_trunks: {msg}")


def twin_trunks(scans, act, crt) -> torch.Tensor:
    """(B, F, NB) scans and the actor and critic trunk weights (each a
    sequence in :data:`WEIGHT_NAMES` order) -> (2, B, 256) features."""
    if scans.device.type == "cpu":
        return twin_trunks_plain(scans, act, crt)
    _require(scans.is_cuda, f"unsupported device {scans.device}")
    _require(scans.dim() == 3, f"scans has shape {tuple(scans.shape)}")
    b, frames, beams = scans.shape
    l1 = (beams - 3) // 2 + 1
    l2 = (l1 - 1) // 2 + 1
    shapes = {"w1": (32, frames, 5), "b1": (32,), "w2": (32, 32, 3),
              "b2": (32,), "wf": (256, 32 * l2), "bf": (256,)}
    weights = [*act, *crt]
    _require(len(weights) == 12, "needs six weights per trunk")
    for name, t in zip(WEIGHT_NAMES * 2, weights):
        _require(tuple(t.shape) == shapes[name],
                 f"{name} has shape {tuple(t.shape)}, wants {shapes[name]}")
    for t in [scans, *weights]:
        _require(t.device == scans.device, f"a tensor is on {t.device}, "
                 f"scans on {scans.device}")
        _require(t.dtype == torch.float32, "tensors must be float32")
        _require(t.is_contiguous(), "tensors must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       [scans, *weights]):
        raise RuntimeError("twin_trunks: the CUDA kernel has no backward "
                           "yet; call it under torch.no_grad()")
    out = torch.empty((2, b, 256), dtype=torch.float32, device=scans.device)
    if b == 0:
        return out
    ptrs = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in weights))
    stream = torch.cuda.current_stream(scans.device).cuda_stream
    status = _launcher()(scans.data_ptr(), ptrs, out.data_ptr(), b, frames,
                         beams, scans.device.index or 0, stream)
    build.check(status, "twin_trunks")
    global launches
    launches += 1
    return out
