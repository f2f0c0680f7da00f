"""The batched collision-avoidance env, plain: A arenas x N disc robots.

One step (``stage_world1.py``, ``circle_world.py``): live robots apply the
clipped action (dead ones v = 0, and w = 0 except in a table world that
never resets, where finished robots keep steering); diff-drive
integration; a robot whose candidate pose overlaps a wall or another
robot keeps its pose (a crash); reward and termination; resets under the
world's rule; one 512-beam lidar frame at the post-reset poses, pushed
into the 3-frame history.  The lidar casts every beam against every wall
segment and every other robot's disc.
"""
from __future__ import annotations

import dataclasses

import torch

from .world import World

EPS = 1e-8
BIG = 1e9
#: Elements of the largest temporary of one lidar chunk.
CHUNK = 1 << 25

RUNNING, GOAL, CRASH, TIMEOUT = 0, 1, 2, 3


@dataclasses.dataclass
class State:
    pose: torch.Tensor       # (A, N, 3)
    speed: torch.Tensor      # (A, N, 2)
    goal: torch.Tensor       # (A, N, 2)
    dist: torch.Tensor       # (A, N)
    step: torch.Tensor       # (A, N) int32
    dead: torch.Tensor       # (A, N) bool
    scan_hist: torch.Tensor  # (A, N, F, B)
    ep_return: torch.Tensor  # (A, N)


def beams(heading, dirs):
    c, s = torch.cos(heading)[..., None], torch.sin(heading)[..., None]
    return c * dirs[:, 0] - s * dirs[:, 1], s * dirs[:, 0] + c * dirs[:, 1]


def cast_walls(origin, dx, dy, seg):
    """(A, N, B) nearest hit of each beam on any segment, BIG where none:
    t = cross(p - o, e) / cross(d, e), u = cross(p - o, d) / cross(d, e),
    a hit where t > 0 and 0 <= u <= 1."""
    px = seg[:, 0] - origin[..., 0:1]                       # (A, N, S)
    py = seg[:, 1] - origin[..., 1:2]
    ex, ey = seg[:, 2], seg[:, 3]
    denom = dx[..., None] * ey - dy[..., None] * ex          # (A, N, B, S)
    ok = denom.abs() > EPS
    safe = torch.where(ok, denom, EPS)
    t = (px * ey - py * ex)[..., None, :] / safe
    u = (px[..., None, :] * dy[..., None]
         - py[..., None, :] * dx[..., None]) / safe
    hit = ok & (t > EPS) & (u >= 0.0) & (u <= 1.0)
    return torch.where(hit, t, BIG).amin(dim=-1)


def cast_discs(origin, dx, dy, radius: float):
    """(A, N, B) nearest hit of each beam on another robot's disc:
    t = b - sqrt(b^2 - c2), b = d . (c - o), c2 = |c - o|^2 - r^2."""
    n = origin.shape[-2]
    oc = origin[..., None, :, :] - origin[..., :, None, :]   # (A, N, M, 2)
    c2 = (oc * oc).sum(-1) - radius * radius                 # (A, N, M)
    b = (dx[..., None] * oc[..., None, :, 0]
         + dy[..., None] * oc[..., None, :, 1])              # (A, N, B, M)
    disc = b * b - c2[..., None, :]
    t = b - torch.sqrt(disc.clamp_min(0.0))
    other = ~torch.eye(n, dtype=torch.bool, device=origin.device)
    hit = (disc > 0.0) & (t > EPS) & other[:, None, :]
    return torch.where(hit, t, BIG).amin(dim=-1)


def lidar(world: World, pose):
    """(A, N, 3) -> (A, N, B) frame, range / max_range - 0.5."""
    a, n, _ = pose.shape
    per_arena = n * world.n_beams * max(world.segments.shape[0], n)
    step = max(1, CHUNK // per_arena)
    out = []
    for lo in range(0, a, step):
        p = pose[lo:lo + step]
        dx, dy = beams(p[..., 2], world.dirs)
        d = torch.minimum(cast_walls(p[..., :2], dx, dy, world.segments),
                          cast_discs(p[..., :2], dx, dy, world.robot_radius))
        out.append(d.clamp_max(world.max_range) / world.max_range - 0.5)
    return torch.cat(out)


def wall_overlap(pos, seg, radius: float):
    """(A, N) bool: the disc at ``pos`` overlaps a wall segment."""
    sp, se = seg[:, :2], seg[:, 2:]
    po = pos[..., None, :] - sp                                # (A, N, S, 2)
    ee = (se * se).sum(-1).clamp_min(1e-12)
    tt = ((po * se).sum(-1) / ee).clamp(0.0, 1.0)
    closest = sp + tt[..., None] * se
    d2 = ((pos[..., None, :] - closest) ** 2).sum(-1)
    return (d2 < radius * radius).any(dim=-1)


def robot_overlap(pos, radius: float):
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    eye = torch.eye(pos.shape[-2], dtype=torch.bool, device=pos.device)
    return ((d2 < (2.0 * radius) ** 2) & ~eye).any(dim=-1)


def local_goal(pose, goal):
    dx = goal[..., 0] - pose[..., 0]
    dy = goal[..., 1] - pose[..., 1]
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    return torch.stack([dx * c + dy * s, -dx * s + dy * c], dim=-1)


def obs(state: State):
    """(scans, goal in the body frame, speed)."""
    return state.scan_hist, local_goal(state.pose, state.goal), state.speed


def first_dist(world: World, pose, goal):
    if world.dist_prev_zero_on_reset:
        return torch.zeros_like(pose[..., 0])
    return torch.linalg.vector_norm(goal - pose[..., :2], dim=-1)


def reset(world: World, pose, goal) -> State:
    z = torch.zeros(pose.shape[:2], device=pose.device)
    frame = lidar(world, pose)
    return State(pose=pose, speed=torch.zeros_like(pose[..., :2]), goal=goal,
                 dist=first_dist(world, pose, goal),
                 step=torch.zeros_like(z, dtype=torch.int32),
                 dead=torch.zeros_like(z, dtype=torch.bool),
                 scan_hist=frame[:, :, None].repeat(1, 1, world.frames, 1),
                 ep_return=z)


def transition(world: World, pose, dead, steps, goal, action):
    """The move and the outcome of one step, before any reset: live robots
    apply the clipped action, a candidate pose overlapping a wall or a
    robot is refused (a crash), and the result code of each live robot.
    Returns a dict of the new ``pose``, ``speed``, ``steps``, ``dist``,
    ``stalled``, ``reached``, ``terminal``, ``result``, ``live``, ``w``."""
    live = ~dead
    v = action[..., 0].clamp(0.0, 1.0) * live
    w = action[..., 1].clamp(-1.0, 1.0)
    if world.reset != "fixed_tables":
        w = w * live
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    cand = torch.stack([x + v * torch.cos(th) * world.dt,
                        y + v * torch.sin(th) * world.dt,
                        th + w * world.dt], dim=-1)
    stalled = (wall_overlap(cand[..., :2], world.segments, world.robot_radius)
               | robot_overlap(cand[..., :2], world.robot_radius))
    new = torch.where(stalled[..., None], pose, cand)
    steps = steps + live.to(torch.int32)
    dist = torch.linalg.vector_norm(goal - new[..., :2], dim=-1)
    reached = dist < world.goal_size
    timeout = steps > world.timeout
    terminal = (reached | stalled | timeout) & live
    result = torch.where(timeout, TIMEOUT, torch.where(
        stalled, CRASH, torch.where(reached, GOAL, RUNNING)))
    return {"pose": new, "speed": torch.stack([v, w], dim=-1),
            "steps": steps, "dist": dist, "stalled": stalled,
            "reached": reached, "terminal": terminal,
            "result": torch.where(live, result, RUNNING), "live": live,
            "w": w}


def step(world: World, st: State, action, reset_pose=None, reset_goal=None):
    """Returns (state', reward, done, info) with info a dict of (A, N)
    ``result``, ``valid``, ``ep_return``, ``reached``, ``crashed``."""
    tr = transition(world, st.pose, st.dead, st.step, st.goal, action)
    live, stalled, reached = tr["live"], tr["stalled"], tr["reached"]
    pose, dist, steps, terminal = (tr["pose"], tr["dist"], tr["steps"],
                                   tr["terminal"])
    w_real = tr["w"] * ~stalled
    reward = (torch.where(reached, 15.0, (st.dist - dist) * 2.5)
              + torch.where(stalled, -15.0, 0.0)
              + torch.where(w_real.abs() > world.omega_thresh,
                            -0.1 * w_real.abs(), 0.0)) * live

    dead_after = st.dead | terminal
    if world.reset == "random_disc":
        mask, dead_next = terminal, torch.zeros_like(dead_after)
    elif world.reset == "all_done_tables":
        mask = dead_after.all(dim=-1, keepdim=True).expand_as(dead_after)
        dead_next = dead_after & ~mask
    elif world.reset == "fixed_tables":
        mask, dead_next = None, dead_after
    else:
        raise ValueError(f"unknown reset rule {world.reset!r}")

    ep_now = st.ep_return + reward
    goal, step_ctr, speed = st.goal, steps, tr["speed"]
    ep_return = ep_now
    if mask is not None:
        m = mask[..., None]
        pose = torch.where(m, reset_pose, pose)
        goal = torch.where(m, reset_goal, goal)
        dist = torch.where(mask, first_dist(world, pose, goal), dist)
        step_ctr = torch.where(mask, 0, step_ctr)
        speed = torch.where(m, 0.0, speed)
        ep_return = torch.where(mask, 0.0, ep_return)
    frame = lidar(world, pose)[:, :, None]
    hist = torch.cat([st.scan_hist[:, :, 1:], frame], dim=2)
    if mask is not None:
        hist = torch.where(mask[..., None, None], frame, hist)
    new = State(pose=pose, speed=speed, goal=goal, dist=dist,
                step=step_ctr.to(torch.int32), dead=dead_next,
                scan_hist=hist, ep_return=ep_return)
    info = {"result": tr["result"], "valid": live,
            "ep_return": torch.where(terminal, ep_now, 0.0),
            "reached": reached & live, "crashed": stalled & live}
    return new, reward, st.dead | terminal, info
