"""Differential-drive kinematics and disc collision (stall) detection.

Counterpart of ``rl_collision_avoidance_tpu/engine/physics.py`` for the disc
footprint.  A robot whose candidate pose would overlap a wall or another
robot keeps its previous pose and raises its stall (crash) flag.
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
