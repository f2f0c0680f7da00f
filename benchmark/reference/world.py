"""A world of a configuration file as plain tensors."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class World:
    name: str
    n_robots: int
    segments: torch.Tensor      # (S, 4) px, py, ex, ey
    dirs: torch.Tensor          # (B, 2) beam directions in the body frame
    frames: int
    robot_radius: float
    max_range: float
    dt: float
    goal_size: float
    omega_thresh: float
    timeout: int
    dist_prev_zero_on_reset: bool
    reset: str                  # random_disc | all_done_tables | fixed_tables
    raw: dict                   # the configuration's world entry as read

    @property
    def n_beams(self) -> int:
        return int(self.dirs.shape[0])


def ring_tables(n: int, radius: float):
    """The circle swap (``model/utils.py``): n robots on a ring, facing
    the centre, bound for the antipode, coordinates rounded to 2
    decimals.  float32 (n, 3) poses and (n, 2) goals."""
    k = np.arange(n)
    ang = k * (2.0 * np.pi / n)
    x = np.round(radius * np.cos(ang), 2)
    y = np.round(radius * np.sin(ang), 2)
    theta = np.pi * (n / 2.0 + k) / (n / 2.0)
    poses = np.stack([x, y, theta], axis=-1).astype(np.float32)
    goals = np.stack([-x, -y], axis=-1).astype(np.float32)
    return poses, goals


def load(config: dict, which: str, device) -> World:
    """``config["worlds"][which]`` on ``device``; the beams and frames come
    from the configuration's model entry."""
    w, m = config["worlds"][which], config["model"]
    ang = np.linspace(-m["fov"] / 2.0, m["fov"] / 2.0, m["beams"])
    dirs = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return World(
        name=w["name"], n_robots=w["n_robots"],
        segments=torch.tensor(w["segments"], dtype=torch.float32,
                              device=device),
        dirs=torch.as_tensor(dirs, device=device), frames=m["frames"],
        robot_radius=w["robot_radius"], max_range=w["max_range"],
        dt=w["dt"], goal_size=w["goal_size"],
        omega_thresh=w["omega_thresh"], timeout=w["timeout"],
        dist_prev_zero_on_reset=w["dist_prev_zero_on_reset"],
        reset=w["reset"], raw=w)


def tables(world: World, device):
    """(N, 3) poses and (N, 2) goals of a table world, on ``device``."""
    poses, goals = ring_tables(world.n_robots, world.raw["ring_radius"])
    return (torch.as_tensor(poses, device=device),
            torch.as_tensor(goals, device=device))


def conv_len(n: int, kernel: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - kernel) // stride + 1


def fc1_inputs(model: dict) -> int:
    c1, c2 = model["conv1"], model["conv2"]
    l1 = conv_len(model["beams"], c1["kernel"], c1["stride"], c1["padding"])
    l2 = conv_len(l1, c2["kernel"], c2["stride"], c2["padding"])
    return c2["channels"] * l2



#: Rounding allowed when a reset sample is held to its world's rule (m, rad).
RULE_EPS = 1e-4


def rule_breaks(world: World, poses: list, goals: list) -> float:
    """The share of reset samples (pose (A, N, 3), goal (A, N, 2) each)
    that break the world's rule: in ``random_disc`` a pose in the spawn
    disc with a heading in [0, 2 pi] and a goal in the disc between
    ``goal_dist_min`` and ``goal_dist_max`` from it; in
    ``all_done_tables`` the ring's table, x and y jittered by at most
    ``pose_jitter``.  1 where no sample was drawn."""
    if not poses:
        return 1.0
    pose, goal = torch.cat(poses), torch.cat(goals)
    w, eps = world.raw, RULE_EPS
    if world.reset == "random_disc":
        radius = w["spawn_radius"]
        dist = torch.linalg.vector_norm(goal - pose[..., :2], dim=-1)
        ok = ((torch.linalg.vector_norm(pose[..., :2], dim=-1) <= radius + eps)
              & (pose[..., 2] >= 0.0) & (pose[..., 2] <= 2.0 * math.pi + eps)
              & (torch.linalg.vector_norm(goal, dim=-1) <= radius + eps)
              & (dist >= w["goal_dist_min"] - eps)
              & (dist <= w["goal_dist_max"] + eps))
    else:
        ring, ring_goal = tables(world, pose.device)
        off = (pose - ring).abs()
        ok = ((off[..., :2] <= w.get("pose_jitter", 0.0) + eps).all(dim=-1)
              & (off[..., 2] <= eps)
              & ((goal - ring_goal).abs() <= eps).all(dim=-1))
    return float((~ok).float().mean())
