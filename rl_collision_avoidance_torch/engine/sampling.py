"""Stage-1 pose/goal samplers: fixed-shape, batched replacements for the
reference's rejection loops (``stage_world1.py:251-274``).

Counterpart of ``rl_collision_avoidance_tpu/engine/sampling.py``.  Random
numbers come from the ``torch.Generator`` the caller passes; they are not
the JAX package's threefry bits, so tests compare distributions, or feed
both sides the same draws.
"""
from __future__ import annotations

import math

import torch

_K = 32


def _first_valid(cands: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """cands (..., K, D), valid (..., K) -> (..., D): the first valid
    candidate of each row (candidate 0 when none is)."""
    idx = valid.to(torch.uint8).argmax(dim=-1)      # first max; 0 when none
    idx = idx[..., None, None].expand(*idx.shape, 1, cands.shape[-1])
    return torch.gather(cands, -2, idx)[..., 0, :]


def stage1_poses(shape, spawn_radius: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """(*shape, 3) poses uniform in the disc of ``spawn_radius`` (polar
    inversion, r = R sqrt(u)), heading U(0, 2 pi)."""
    u = torch.rand((3, *shape), generator=generator, device=device)
    r = spawn_radius * torch.sqrt(u[0])
    phi = 2.0 * math.pi * u[1]
    theta = 2.0 * math.pi * u[2]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), theta], dim=-1)


def stage1_goals(pose_xy: torch.Tensor, spawn_radius: float, dmin: float,
                 dmax: float, generator: torch.Generator) -> torch.Tensor:
    """(..., 2) goals uniform on disc(spawn_radius) ∩ annulus(dmin, dmax)
    around each start ``pose_xy`` (..., 2).

    K candidates per robot are drawn uniformly on the annulus and the first
    inside the disc is kept; the none-valid fallback (< ~1e-5 per reset)
    projects the first candidate into the disc so the goal stays reachable.
    """
    u = torch.rand((2, *pose_xy.shape[:-1], _K), generator=generator,
                   device=pose_xy.device)
    r = torch.sqrt(dmin * dmin + u[0] * (dmax * dmax - dmin * dmin))
    phi = 2.0 * math.pi * u[1]
    cand = pose_xy[..., None, :] + torch.stack(
        [r * torch.cos(phi), r * torch.sin(phi)], dim=-1)          # (..., K, 2)
    goal = _first_valid(cand, torch.linalg.vector_norm(cand, dim=-1)
                        <= spawn_radius)
    norm = torch.linalg.vector_norm(goal, dim=-1).clamp_min(1e-6)
    scale = (spawn_radius / norm).clamp_max(1.0)
    return goal * scale[..., None]
