"""The lidar kernel's wrapper and its plain PyTorch version.

:func:`lidar_obs` computes one normalized lidar frame, ``range / max_range
- 0.5``, for every robot of every arena.  On CUDA tensors it launches the
hand-written kernel in ``csrc/lidar.cu`` (which replaces
``rl_collision_avoidance_tpu/ops/lidar_pallas.py::_kernel``); on CPU tensors
it runs :func:`lidar_obs_plain`, the unfused chain of cell lookup, gather,
``engine/lidar.py::raycast_culled`` and the normalize.  There is no fallback
between the two: a CUDA tensor that the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..engine.celltable import lookup_cells
from ..engine.lidar import raycast_culled
from . import build

#: Kernel launches since the count was last set to 0.
launches = 0


def lidar_obs_plain(pose, table, lo, cell: float, grid, dirs, radius: float,
                    max_range: float) -> torch.Tensor:
    """Plain version: pose (A, N, 3), cell table (C, K, 4) with origin
    ``lo``, edge ``cell`` and grid (nx, ny), beam table dirs (B, 2) ->
    (A, N, B) normalized ranges."""
    culled = table[lookup_cells(lo, cell, grid, pose[..., :2])]   # (A, N, K, 4)
    ranges = raycast_culled(pose, dirs, culled, radius, max_range)
    return ranges / max_range - 0.5


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library().lidar_obs_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f, f, f, f, i, p]
    fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lidar_obs: {msg}")


def lidar_obs(pose, table, lo, cell: float, grid, dirs, radius: float,
              max_range: float) -> torch.Tensor:
    """(A, N, B) normalized lidar frame; see :func:`lidar_obs_plain`."""
    if pose.device.type == "cpu":
        return lidar_obs_plain(pose, table, lo, cell, grid, dirs, radius,
                               max_range)
    _require(pose.is_cuda, f"unsupported device {pose.device}")
    for name, t, ndim, last in (("pose", pose, 3, 3), ("table", table, 3, 4),
                                ("dirs", dirs, 2, 2)):
        _require(t.device == pose.device, f"{name} is on {t.device}, "
                 f"pose on {pose.device}")
        _require(t.dtype == torch.float32, f"{name} must be float32")
        _require(t.dim() == ndim and t.shape[-1] == last,
                 f"{name} has shape {tuple(t.shape)}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    nx, ny = grid
    _require(table.shape[0] == nx * ny, "table rows do not match the grid")
    a, n, _ = pose.shape
    beams, k = dirs.shape[0], table.shape[1]
    out = torch.empty((a, n, beams), dtype=torch.float32, device=pose.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(pose.device).cuda_stream
    status = _launcher()(
        pose.data_ptr(), table.data_ptr(), dirs.data_ptr(), out.data_ptr(),
        a, n, beams, k, nx, ny, float(lo[0]), float(lo[1]), float(cell),
        float(radius * radius), float(max_range), pose.device.index or 0,
        stream)
    build.check(status, "lidar_obs")
    global launches
    launches += 1
    return out
