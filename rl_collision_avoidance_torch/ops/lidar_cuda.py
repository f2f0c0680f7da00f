"""The lidar kernel's wrapper, its plain PyTorch version and its culling rules.

:func:`lidar_obs` computes one normalized lidar frame, ``range / max_range
- 0.5``, for every robot of every arena.  On CUDA tensors it launches the
hand-written kernel in ``csrc/lidar.cu`` (which replaces
``rl_collision_avoidance_tpu/ops/lidar_pallas.py::_kernel``); on CPU tensors
it runs :func:`lidar_obs_plain`, the unfused chain of cell lookup, gather,
``engine/lidar.py::raycast_culled`` and the normalize.  There is no fallback
between the two: a CUDA tensor that the kernel cannot take raises.  With
``discs=False`` both compute the walls alone (the kernel keeps no disc),
for the env to combine with silhouettes it computes itself: boxes, or the
k nearest discs.

The kernel skips candidates that cannot change its result.  Each rule it
uses is stated once below (:func:`live_slots`, :func:`disc_kept`), for the
tests; the kernel does not call them.
:func:`adversarial_poses` builds an arena of the cases those rules have to
get right.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch

from ..engine.celltable import lookup_cells
from ..engine.lidar import raycast_culled, raycast_walls, rotate_beams
from ..utils import graphs
from . import build

#: Kernel launches since the count was last set to 0.
launches = 0
#: The same launches by (mode, robots, "float32"): mode "lidar_obs" for the
#: walls and the discs, "lidar_obs_walls" for the walls alone.
launches_by_mode: collections.Counter = collections.Counter()


def _count(mode: str, robots: int) -> None:
    global launches
    launches += 1
    launches_by_mode[mode, robots, "float32"] += 1

#: The far-disc cut leaves this share of ``max_range`` as a margin over the
#: float32 rounding of a hit distance (< 4e-4 of it; see :func:`disc_kept`).
FAR_MARGIN = 1.0 / 64.0


def lidar_obs_plain(pose, table, lo, cell: float, grid, dirs, radius: float,
                    max_range: float, discs: bool = True) -> torch.Tensor:
    """Plain version: pose (A, N, 3), cell table (C, K, 4) with origin
    ``lo``, edge ``cell`` and grid (nx, ny), beam table dirs (B, 2) ->
    (A, N, B) normalized ranges; the walls alone with ``discs=False``."""
    culled = table[lookup_cells(lo, cell, grid, pose[..., :2])]   # (A, N, K, 4)
    if discs:
        ranges = raycast_culled(pose, dirs, culled, radius, max_range)
    else:
        dx, dy = rotate_beams(pose[..., 2], dirs)
        ranges = raycast_walls(pose, dx, dy, culled).clamp_max(max_range)
    return ranges / max_range - 0.5


@functools.lru_cache(maxsize=None)
def far_disc_c2(radius: float, max_range: float) -> float:
    """The float32 bound on ``c2 = |c - o|^2 - r^2`` from which on a disc is
    not tested: its centre lies farther than ``max_range (1 + FAR_MARGIN) +
    r`` from the origin."""
    reach = max_range * (1.0 + FAR_MARGIN) + radius
    return float(np.float32(reach * reach - radius * radius))


def live_slots(table: torch.Tensor) -> torch.Tensor:
    """Rule: the kernel tests a cell-table slot only where its segment has
    e != 0.  A padding slot (``engine/celltable.py``) has e = 0, so w = 0,
    t_num = 0 and t = 0: it never hits.  (C, K, 4) -> (C, K) bool."""
    return (table[..., 2] != 0.0) | (table[..., 3] != 0.0)


def disc_kept(c2: torch.Tensor, radius: float, max_range: float):
    """Rule: the kernel tests another robot's disc only where the float32
    ``c2 = |c - o|^2 - r^2`` of the plain version is in (0, far_disc_c2).

    - c2 <= 0 (the origin inside or on the disc) never hits: with
      s = sqrt(b^2 - c2) rounded, b^2 - c2 >= rn(b^2) gives s >= |b|,
      because sqrt(rn(b^2)) rounds to |b| in binary floating point, so
      t = b - s <= 0.
    - c2 >= far_disc_c2: the exact hit distance is at least |c - o| - r >=
      max_range (1 + FAR_MARGIN); float32 rounding moves the computed one by
      less than 4e-4 of |c - o| (most at a tangent beam, where the root of a
      rounded b^2 - c2 near 0 errs by up to sqrt(6e-8) |c - o|), so any hit
      lies beyond max_range and the clip gives max_range either way.
    """
    return (c2 > 0.0) & (c2 < far_disc_c2(radius, max_range))


def adversarial_poses(spec, n: int, seed: int = 0) -> np.ndarray:
    """(1, n, 3) float32 poses of one arena of the world ``spec`` built to
    sit on the culling rules' edges.  As seen from robot 0: discs
    overlapping it (c2 < 0) and with their edge on it (c2 ~ 0), a pair 2r
    apart, discs tangent to beams (from inside and outside the disc by ~1e-6
    of r), discs at exactly max_range + r and at the far cut on a beam,
    discs on the two field-of-view edge beams and tangent to them from
    outside the field of view.  Then robots on the line of the shortest and
    of a long wall beyond its ends (on it, 1e-6, 5e-4 and 2e-3 m off it),
    looking along it.  The other robots uniform in the 19 m square around
    the origin; headings uniform.  Needs n >= 24."""
    radius, max_range = spec.robot_radius, spec.max_range
    fov, n_beams = spec.fov, spec.n_beams
    rng = np.random.default_rng(seed)
    pose = np.empty((n, 3), np.float64)
    pose[:, :2] = rng.uniform(-9.5, 9.5, (n, 2))
    pose[:, 2] = rng.uniform(-np.pi, np.pi, n)
    o, th = np.array([-2.0, 0.5]), 0.3
    pose[0] = (*o, th)
    ang = lambda b: th - fov / 2 + fov * b / (n_beams - 1)
    unit = lambda a: np.array([np.cos(a), np.sin(a)])
    tangent = lambda b, dist, off: (o + dist * unit(ang(b))
                                    + off * radius * unit(ang(b) + np.pi / 2))
    far = math.sqrt(far_disc_c2(radius, max_range) + radius * radius)
    edge = lambda dist: math.asin(min(1.0, radius / dist))
    keep = math.nan                  # the heading stays the random one
    at = [(*(o + 0.5 * radius * unit(1.0)), keep),         # overlapping
          (*(o + radius * (1 - 1e-6) * unit(2.0)), keep),   # just inside
          (*(o + radius * unit(2.5)), keep),                 # on the edge
          (*(o + radius * (1 + 1e-6) * unit(th)), keep),     # just outside
          (*(o + 2 * radius * unit(th + 0.7)), keep),        # 2r apart
          (*tangent(n_beams // 3, 1.0, 1.0), keep),          # tangent beams
          (*tangent(n_beams // 2, 3.0, 1.0 - 1e-6), keep),
          (*tangent(2 * n_beams // 3, 5.5, 1.0 + 1e-6), keep),
          (*(o + (max_range + radius) * unit(ang(n_beams // 5))), keep),
          (*(o + (max_range + radius) * (1 - 1e-6)
             * unit(ang(n_beams // 6))), keep),
          (*(o + far * unit(ang(3 * n_beams // 4))), keep),  # the far cut
          (*(o + far * (1 - 1e-6) * unit(ang(5 * n_beams // 6))), keep),
          (*(o + 2.0 * unit(ang(0))), keep),                 # the FOV edges
          (*(o + 2.5 * unit(ang(n_beams - 1))), keep),
          (*(o + 1.5 * unit(ang(0) - edge(1.5))), keep),     # tangent to them
          (*(o + 3.0 * unit(ang(n_beams - 1) + edge(3.0) * (1 + 1e-6))),
           keep),
          (*(o + 4.0 * unit(ang(0) - edge(4.0) * (1 - 1e-6))), keep)]
    valid = np.asarray(spec.seg_valid, bool)
    seg_p = np.asarray(spec.seg_p, np.float64)[valid]
    seg_e = np.asarray(spec.seg_e, np.float64)[valid]
    length = np.hypot(seg_e[:, 0], seg_e[:, 1])
    for i, cases in ((int(np.argmin(length)), ((0.5, 0.0), (-0.3, 5e-4),
                                               (1.0, 2e-3))),
                     (int(np.argsort(length)[len(length) // 2]),
                      ((0.4, 0.0), (-1.5, 1e-6), (2.0, -2e-3)))):
        e = seg_e[i] / length[i]
        normal = np.array([-e[1], e[0]])
        for beyond, off in cases:    # past the far end (> 0) or the near one
            end = seg_p[i] + seg_e[i] if beyond > 0 else seg_p[i]
            look = math.atan2(*(-e if beyond > 0 else e)[::-1])
            at.append((*(end + beyond * e + off * normal), look))
    if n < len(at) + 1:
        raise ValueError(f"adversarial_poses needs n >= {len(at) + 1}")
    at = np.asarray(at)
    pose[1:len(at) + 1, :2] = at[:, :2]
    pose[1:len(at) + 1, 2] = np.where(np.isnan(at[:, 2]),
                                      pose[1:len(at) + 1, 2], at[:, 2])
    return pose.astype(np.float32)[None]


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library().lidar_obs_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f, f, f, f, f, i, p]
    fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg) -> None:
    """Raise ValueError with ``msg()`` when ``cond`` fails; the message is
    built only then."""
    if not cond:
        raise ValueError(f"lidar_obs: {msg()}")


def lidar_obs(pose, table, lo, cell: float, grid, dirs, radius: float,
              max_range: float, discs: bool = True) -> torch.Tensor:
    """(A, N, B) normalized lidar frame; see :func:`lidar_obs_plain`.  With
    ``discs=False`` the kernel gets a far-disc bound of 0, so its keep rule
    (0 < c2 < far) keeps no disc and it computes the walls alone."""
    if pose.device.type == "cpu":
        return lidar_obs_plain(pose, table, lo, cell, grid, dirs, radius,
                               max_range, discs)
    _require(pose.is_cuda, lambda: f"unsupported device {pose.device}")
    for name, t, ndim, last, align in (("pose", pose, 3, 3, 4),
                                       ("table", table, 3, 4, 16),
                                       ("dirs", dirs, 2, 2, 8)):
        _require(t.device == pose.device,
                 lambda: f"{name} is on {t.device}, pose on {pose.device}")
        _require(t.dtype == torch.float32,
                 lambda: f"{name} must be float32")
        _require(t.dim() == ndim and t.shape[-1] == last,
                 lambda: f"{name} has shape {tuple(t.shape)}")
        _require(t.is_contiguous(), lambda: f"{name} must be contiguous")
        _require(t.data_ptr() % align == 0,
                 lambda: f"{name} must start on a {align}-byte boundary")
    nx, ny = grid
    _require(table.shape[0] == nx * ny,
             lambda: "table rows do not match the grid")
    a, n, _ = pose.shape
    beams, k = dirs.shape[0], table.shape[1]
    out = torch.empty((a, n, beams), dtype=torch.float32, device=pose.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(pose.device).cuda_stream
    status = _launcher()(
        pose.data_ptr(), table.data_ptr(), dirs.data_ptr(), out.data_ptr(),
        a, n, beams, k, nx, ny, float(lo[0]), float(lo[1]), float(cell),
        float(radius * radius), float(max_range),
        far_disc_c2(radius, max_range) if discs else 0.0,
        pose.device.index or 0, stream)
    build.check(status, "lidar_obs")
    graphs.launched(_count, "lidar_obs" if discs else "lidar_obs_walls",
                    a * n)
    return out
