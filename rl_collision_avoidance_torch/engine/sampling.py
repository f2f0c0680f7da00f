"""Pose/goal samplers: fixed-shape, batched replacements for the
reference's rejection loops (``stage_world1.py:251-274``,
``stage_world2.py:250-287``).

Counterpart of ``rl_collision_avoidance_tpu/engine/sampling.py``.  Random
numbers come from the ``torch.Generator`` the caller passes; they are not
the JAX package's threefry bits, so tests compare distributions, or feed
both sides the same draws.  Each sampler is a draw, then a map: the
``*_from`` maps take the uniforms as an argument.  They are the CPU's path
and the plain version that the card's sampler kernel
(``ops/env_cuda.py::sample``) is held to bit for bit.
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


def stage1_poses_from(u: torch.Tensor, spawn_radius: float) -> torch.Tensor:
    """u (3, ...) uniforms -> (..., 3) poses uniform in the disc of
    ``spawn_radius`` (polar inversion, r = R sqrt(u[0])), heading
    2 pi u[2]."""
    r = spawn_radius * torch.sqrt(u[0])
    phi = 2.0 * math.pi * u[1]
    theta = 2.0 * math.pi * u[2]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), theta], dim=-1)


def stage1_goals_from(u: torch.Tensor, pose_xy: torch.Tensor,
                      spawn_radius: float, dmin: float,
                      dmax: float) -> torch.Tensor:
    """u (2, ..., K) uniforms, pose_xy (..., 2) -> (..., 2) goals uniform on
    disc(spawn_radius) ∩ annulus(dmin, dmax) around each start.

    The K candidates lie uniformly on the annulus and the first inside the
    disc is kept; the none-valid fallback (< ~1e-5 per reset) projects the
    first candidate into the disc so the goal stays reachable.
    """
    r = torch.sqrt(dmin * dmin + u[0] * (dmax * dmax - dmin * dmin))
    phi = 2.0 * math.pi * u[1]
    cand = pose_xy[..., None, :] + torch.stack(
        [r * torch.cos(phi), r * torch.sin(phi)], dim=-1)          # (..., K, 2)
    goal = _first_valid(cand, torch.linalg.vector_norm(cand, dim=-1)
                        <= spawn_radius)
    norm = torch.linalg.vector_norm(goal, dim=-1).clamp_min(1e-6)
    scale = (spawn_radius / norm).clamp_max(1.0)
    return goal * scale[..., None]


def stage1_poses(shape, spawn_radius: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """(*shape, 3) poses uniform in the disc of ``spawn_radius``."""
    u = torch.rand((3, *shape), generator=generator, device=device)
    return stage1_poses_from(u, spawn_radius)


def stage1_goals(pose_xy: torch.Tensor, spawn_radius: float, dmin: float,
                 dmax: float, generator: torch.Generator) -> torch.Tensor:
    """(..., 2) goals in disc(spawn_radius) ∩ annulus(dmin, dmax) around
    each start ``pose_xy`` (..., 2): :func:`stage1_goals_from` of K
    candidates a start."""
    u = torch.rand((2, *pose_xy.shape[:-1], _K), generator=generator,
                   device=pose_xy.device)
    return stage1_goals_from(u, pose_xy, spawn_radius, dmin, dmax)


def table_poses_from(u: torch.Tensor, table: torch.Tensor,
                     jitter: float) -> torch.Tensor:
    """u (..., 2) uniforms, table (N, 3) -> (..., N, 3): the table poses with
    x/y moved by jitter (2 u - 1), uniform in +-jitter; headings exact."""
    pose = table.expand(*u.shape[:-1], 3).clone()
    pose[..., :2] += jitter * (2.0 * u - 1.0)
    return pose


def _corridor_xy(u_x: torch.Tensor, u_y: torch.Tensor) -> torch.Tensor:
    """The stage-2 south-east corridor's piecewise map (stage_world2.py:
    252-257): x ~ U(9, 19); u ~ U(0, 1), u <= 0.4 maps to y in [-5, -1],
    else y in (-19, -13]."""
    x = 9.0 + 10.0 * u_x
    y = torch.where(u_y <= 0.4, -(u_y * 10.0 + 1.0), -(u_y * 10.0 + 9.0))
    return torch.stack([x, y], dim=-1)


def corridor_poses_from(u: torch.Tensor, cur_xy: torch.Tensor) -> torch.Tensor:
    """u (3, ..., K) uniforms, cur_xy (..., 2) -> (..., 3) corridor poses,
    the first of K candidates >= 7 m from the current position, heading
    2 pi u[2, ..., 0] (stage_world2.py:250-268)."""
    cand = _corridor_xy(u[0], u[1])                              # (..., K, 2)
    d = torch.linalg.vector_norm(cand - cur_xy[..., None, :], dim=-1)
    pos = _first_valid(cand, d >= 7.0)
    theta = 2.0 * math.pi * u[2, ..., 0]
    return torch.cat([pos, theta[..., None]], dim=-1)


def corridor_goals_from(u: torch.Tensor, pose_xy: torch.Tensor) -> torch.Tensor:
    """u (2, ..., K) uniforms, pose_xy (..., 2) -> (..., 2) corridor goals,
    the first of K candidates >= 7 m from the (new) pose
    (stage_world2.py:270-287)."""
    cand = _corridor_xy(u[0], u[1])
    d = torch.linalg.vector_norm(cand - pose_xy[..., None, :], dim=-1)
    return _first_valid(cand, d >= 7.0)


def corridor_poses(cur_xy: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """(..., 3) corridor poses >= 7 m from each current position."""
    u = torch.rand((3, *cur_xy.shape[:-1], _K), generator=generator,
                   device=cur_xy.device)
    return corridor_poses_from(u, cur_xy)


def corridor_goals(pose_xy: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """(..., 2) corridor goals >= 7 m from each pose."""
    u = torch.rand((2, *pose_xy.shape[:-1], _K), generator=generator,
                   device=pose_xy.device)
    return corridor_goals_from(u, pose_xy)
