"""Differential-drive kinematics and collision (stall) detection.

Counterpart of ``rl_collision_avoidance_tpu/engine/physics.py``, for both
footprints: the disc of ``robot_radius`` and Stage's exact 0.44 x 0.38 m
oriented box (``worlds/stage1.world:83``).  A robot whose candidate pose
would overlap a wall or another robot keeps its previous pose and raises
its stall (crash) flag.
"""
from __future__ import annotations

import torch


def integrate(pose: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              dt: float, substeps: int = 1) -> torch.Tensor:
    """Kinematic diff-drive update of (..., 3) poses by (...,) v and w: each
    substep translates along the current heading, then rotates."""
    h = dt / substeps
    for _ in range(substeps):
        x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
        x = x + v * torch.cos(th) * h
        y = y + v * torch.sin(th) * h
        th = th + w * h
        pose = torch.stack([x, y, th], dim=-1)
    return pose


def wall_collision_packed(pos: torch.Tensor, culled: torch.Tensor,
                          radius: float) -> torch.Tensor:
    """(..., N) bool: does the disc at ``pos`` (..., N, 2) overlap any of its
    candidate segments ``culled`` (..., N, K, 4) [px, py, ex, ey] from the
    wall cell table?  Degenerate padding entries never trigger."""
    sp, se = culled[..., :2], culled[..., 2:]
    po = pos[..., :, None, :] - sp                                 # (..., N, K, 2)
    ee = (se * se).sum(-1).clamp_min(1e-12)
    tt = ((po * se).sum(-1) / ee).clamp(0.0, 1.0)
    closest = sp + tt[..., None] * se
    d2 = ((pos[..., :, None, :] - closest) ** 2).sum(-1)
    return (d2 < radius * radius).any(dim=-1)


def robot_collision(pos: torch.Tensor, radius: float) -> torch.Tensor:
    """(..., N) bool: pairwise disc overlap (diameter threshold), self excluded."""
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    n = pos.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    return ((d2 < (2.0 * radius) ** 2) & ~eye).any(dim=-1)


def rect_wall_collision(pose: torch.Tensor, culled: torch.Tensor,
                        half_len: float, half_wid: float) -> torch.Tensor:
    """(..., N) bool: does the oriented box of half-dims (``half_len``,
    ``half_wid``) at ``pose`` (..., N, 3) overlap any of its candidate
    segments ``culled`` (..., N, K, 4)?  Each segment is moved into the
    body frame and clipped against the axis-aligned box (Liang-Barsky
    slabs, branchless).  The cell table must be built with the box's
    circumradius, so that the candidates cover every wall it can touch;
    padding entries (e = 0, far outside) never hit."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    rel = culled[..., :2] - pose[..., None, :2]                    # (..., N, K, 2)
    p0x = rel[..., 0] * c + rel[..., 1] * s                        # body frame
    p0y = -rel[..., 0] * s + rel[..., 1] * c
    ex = culled[..., 2] * c + culled[..., 3] * s
    ey = -culled[..., 2] * s + culled[..., 3] * c

    def slab(p0, e, h):
        # a sign-preserving guard keeps e = 0 from dividing by zero
        tiny = torch.where(e < 0, -1e-12, 1e-12)
        e_safe = torch.where(e.abs() < 1e-12, tiny, e)
        t0 = (-h - p0) / e_safe
        t1 = (h - p0) / e_safe
        return torch.minimum(t0, t1), torch.maximum(t0, t1)

    nx0, nx1 = slab(p0x, ex, half_len)
    ny0, ny1 = slab(p0y, ey, half_wid)
    t_near = torch.maximum(nx0, ny0).clamp_min(0.0)
    t_far = torch.minimum(nx1, ny1).clamp_max(1.0)
    return (t_near <= t_far).any(dim=-1)


def rect_robot_collision(pose: torch.Tensor, half_len: float,
                         half_wid: float) -> torch.Tensor:
    """(..., N) bool: pairwise oriented-box overlap of the robots at ``pose``
    (..., N, 3), self excluded, by the separating-axis test on the four
    candidate axes of two boxes (each box's body x and y)."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    u = torch.stack([c, s], dim=-1)                                # body x axis
    v = torch.stack([-s, c], dim=-1)                               # body y axis
    d = pose[..., None, :, :2] - pose[..., :, None, :2]            # (..., N, M, 2)

    def separated_on(axis):
        # axis (..., N, M, 2): the pair's candidate unit vectors
        proj_d = (d * axis).sum(-1).abs()
        ri = (half_len * (u[..., :, None, :] * axis).sum(-1).abs()
              + half_wid * (v[..., :, None, :] * axis).sum(-1).abs())
        rj = (half_len * (u[..., None, :, :] * axis).sum(-1).abs()
              + half_wid * (v[..., None, :, :] * axis).sum(-1).abs())
        return proj_d > ri + rj

    bc = lambda x: x.expand(d.shape)
    sep = (separated_on(bc(u[..., :, None, :]))
           | separated_on(bc(v[..., :, None, :]))
           | separated_on(bc(u[..., None, :, :]))
           | separated_on(bc(v[..., None, :, :])))
    eye = torch.eye(pose.shape[-2], dtype=torch.bool, device=pose.device)
    return (~sep & ~eye).any(dim=-1)
