"""512-beam lidar, plain PyTorch: dense and culled ray/segment and ray/disc
intersection.

Counterpart of ``rl_collision_avoidance_tpu/engine/lidar.py`` for the disc
footprint.  These are the plain versions: :func:`raycast_culled` is what
the hand-written lidar kernel (``ops/csrc/lidar.cu``) computes and is held
against, and the dense :func:`scan` is the reference both are tested with.
All geometry stays float32; nothing here goes through a matrix unit, so no
TF32 setting can reach it.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-8
BIG = 1e9


def sparse_beam_index(raw: int, sparse: int) -> np.ndarray:
    """The reference's left/right two-pointer lidar resample as a static
    index table (``stage_world1.py:122-140``): the left half walks indices
    ``int(k * raw / sparse)`` up from beam 0, the right half walks down from
    beam ``raw - 1``, and the two meet in the middle.  For ``sparse == raw``
    it is the identity."""
    step = float(raw) / float(sparse)
    # Accumulate as the reference loop does: its running float index drifts
    # (6 * (512 / 24) accumulates to 127.999... -> 127, not 128), and the
    # drift is part of the observed behavior.
    left, index = [], 0.0
    for _ in range(sparse // 2):
        left.append(int(index))
        index += step
    right, index = [], raw - 1.0
    for _ in range(sparse // 2):
        right.append(int(index))
        index -= step
    return np.asarray(left + right[::-1], np.int32)


def beam_directions_local(n_beams: int, fov: float) -> np.ndarray:
    """(B, 2) unit beam directions in the robot body frame; beam 0 points to
    angle -fov/2 (the robot's right for fov = pi)."""
    ang = np.linspace(-fov / 2.0, fov / 2.0, n_beams)
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def _rotate_beams(heading: torch.Tensor, local_dirs: torch.Tensor):
    """(..., N) heading x (B, 2) local dirs -> world-frame (dx, dy), each
    (..., N, B)."""
    c, s = torch.cos(heading)[..., None], torch.sin(heading)[..., None]
    lx, ly = local_dirs[:, 0], local_dirs[:, 1]
    return c * lx - s * ly, s * lx + c * ly


def raycast_segments(origins, dx, dy, seg_p, seg_e, seg_valid):
    """Min hit distance of rays against static segments (BIG where none).

    origins (N, 2); dx/dy (N, B); seg_p/seg_e (S, 2); seg_valid (S,).
    Ray o + t d vs segment p + u e with cross(a, b) = ax by - ay bx:
    t = cross(p - o, e) / cross(d, e), u = cross(p - o, d) / cross(d, e),
    hit iff t > 0 and u in [0, 1].
    """
    po = seg_p[None, :, :] - origins[:, None, :]                 # (N, S, 2)
    ex, ey = seg_e[:, 0], seg_e[:, 1]
    denom = dx[..., None] * ey - dy[..., None] * ex              # (N, B, S)
    t_num = po[..., 0] * ey - po[..., 1] * ex                    # (N, S)
    u_num = (po[:, None, :, 0] * dy[..., None]
             - po[:, None, :, 1] * dx[..., None])                # (N, B, S)
    ok = denom.abs() > EPS
    safe = torch.where(ok, denom, torch.full_like(denom, EPS))
    t = t_num[:, None, :] / safe
    u = u_num / safe
    hit = ok & (t > EPS) & (u >= 0.0) & (u <= 1.0) & seg_valid
    return torch.where(hit, t, torch.full_like(t, BIG)).amin(dim=-1)


def raycast_discs(origins, dx, dy, radius: float):
    """Min hit distance of each robot's rays against the other robots'
    discs (self excluded).  origins (N, 2); dx/dy (N, B) -> (N, B).
    Ray-circle: t = b - sqrt(b^2 - c) with b = d.(c - o), c = |c - o|^2 - r^2.
    """
    n = origins.shape[0]
    oc = origins[None, :, :] - origins[:, None, :]               # (N, M, 2)
    b = dx[..., None] * oc[:, None, :, 0] + dy[..., None] * oc[:, None, :, 1]
    c2 = (oc * oc).sum(-1) - radius * radius                     # (N, M)
    disc = b * b - c2[:, None, :]
    t = b - torch.sqrt(disc.clamp_min(0.0))
    not_self = ~torch.eye(n, dtype=torch.bool, device=origins.device)
    hit = (disc > 0.0) & (t > EPS) & not_self[:, None, :]
    return torch.where(hit, t, torch.full_like(t, BIG)).amin(dim=-1)


def raycast_culled(pose, local_dirs, culled, radius: float, max_range: float):
    """Culled raycast batched over arenas, with the lidar kernel's 13-op
    segment test.

    pose (A, N, 3); local_dirs (B, 2); culled (A, N, K, 4) [px, py, ex, ey]
    per-robot candidate segments from the cell table.  Returns (A, N, B)
    ranges clipped to ``max_range``, robot discs of the same arena included.
    With w = cross(d, e) and c0 = cross(p0 - o, d) = u w, the window test
    u in [0, 1] is the sign test c0 (w - c0) >= 0, and t = cross(p0 - o, e) / w.
    """
    n = pose.shape[-2]
    x, y = pose[..., 0:1], pose[..., 1:2]
    dx, dy = _rotate_beams(pose[..., 2], local_dirs)              # (A, N, B)
    px = culled[..., 0] - x                                       # (A, N, K)
    py = culled[..., 1] - y
    ex, ey = culled[..., 2], culled[..., 3]
    w = dx[..., None] * ey[..., None, :] - dy[..., None] * ex[..., None, :]
    c0 = px[..., None, :] * dy[..., None] - py[..., None, :] * dx[..., None]
    t_num = (px * ey - py * ex)[..., None, :]                     # (A, N, 1, K)
    win = c0 * (w - c0)
    t = t_num / torch.where(w == 0.0, torch.full_like(w, EPS), w)
    hit = (win >= 0.0) & (t > EPS)
    d_seg = torch.where(hit, t, torch.full_like(t, BIG)).amin(dim=-1)

    oc = pose[..., None, :, :2] - pose[..., :, None, :2]          # (A, N, M, 2)
    c2 = (oc * oc).sum(-1) - radius * radius                      # (A, N, M)
    eye = torch.eye(n, dtype=torch.bool, device=pose.device)
    c2 = torch.where(eye, torch.full_like(c2, BIG), c2)
    b = (dx[..., None] * oc[..., None, :, 0]
         + dy[..., None] * oc[..., None, :, 1])                   # (A, N, B, M)
    disc = b * b - c2[..., None, :]
    td = b - torch.sqrt(disc.clamp_min(0.0))
    hitd = (disc > 0.0) & (td > EPS)
    d_rob = torch.where(hitd, td, torch.full_like(td, BIG)).amin(dim=-1)
    return torch.minimum(d_seg, d_rob).clamp_max(max_range)


def scan(pose, local_dirs, seg_p, seg_e, seg_valid, robot_radius: float,
         max_range: float):
    """Dense lidar scan of one arena against every segment.

    pose (N, 3) [x, y, theta] -> ranges (N, B) clipped to ``max_range``.
    """
    origins = pose[:, :2]
    dx, dy = _rotate_beams(pose[:, 2], local_dirs)
    d_seg = raycast_segments(origins, dx, dy, seg_p, seg_e, seg_valid)
    d_rob = raycast_discs(origins, dx, dy, robot_radius)
    return torch.minimum(d_seg, d_rob).clamp_max(max_range)
