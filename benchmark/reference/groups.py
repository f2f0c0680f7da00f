"""The stage-2 world, plain: robots that reset by scenario group, the
corridor sampler's rule, and the training updates around that step
(``ppo_stage2.py``, ``stage_world2.py``, ``model/utils.py:41-87``).

A world whose ``reset`` is ``group_tables_corridor`` splits its robots into
the scenario groups ``group_bounds``.  A robot that reaches its goal,
crashes or times out waits dead (v = w = 0, no reward) until every member
of its group is dead or terminal; then the whole group resets at once:
robots below ``len(table_poses)`` to their table pose and goal, the rest
to a corridor pose and goal.  The move, the collisions, the reward and the
termination are ``env.py``'s (``stage_world2.py`` has
``stage_world1.py``'s).

Departures from ``stage_world2.py`` and ``ppo_stage2.py``, all of them the
program's documented behaviour that the configuration states: A arenas,
each a replica of the world, step at once; the rejection loops of
``generate_random_pose`` and ``generate_random_goal`` become the first of
``corridor["candidates"]`` candidates (the benchmark draws the samples;
:func:`rule_breaks` holds the program's own sampler to the rule); a
group's reset happens inside the step in which its last member finishes,
and the step's frame is taken at the fresh poses; a waiting robot's steps
stay in the rollout, dead, with weight 0, where the script's robot process
idles.

The reference follows the program's states: each acting step starts from
the program's state before it, its scan history included, so rounding
cannot compound from step to step.  The trained policy in the stage-2
scenarios is chaotic: on the CPU in float32, a nudge of one part in a
million to one bias parts 31 of 704 robots by metres within 128 steps.
Nor can the reference's own frames stand in for the program's: a beam
that grazes a wall's end or a disc flips between hit and miss on a
rounding of the pose, and the trained policy answers a flipped beam with
another action.  The policy, the step's outputs, GAE and PPO are the
reference's own.  Its next state is held to the program's after each step:
the robot-steps whose ``dead`` or step counter differ (a reset the program
made or left out, a crash or arrival decided otherwise) are counted, and
on the others the largest gap of the pose (x, y, heading), the goal, the
distance and the speed is taken; its dense ray cast is held to the
program's frame at the program's pose (``frame_share``).
"""
from __future__ import annotations

import math

import torch

from . import env, policy, ppo
from .train import batch
from .world import RULE_EPS, World


def members(world: World, device) -> torch.Tensor:
    """(G, N) bool: robot n belongs to group g."""
    bounds = world.raw["group_bounds"]
    n = torch.arange(world.n_robots, device=device)
    return torch.stack([(n >= lo) & (n < hi)
                        for lo, hi in zip(bounds, bounds[1:])])


def step(world: World, st: env.State, action, reset_pose, reset_goal):
    """``env.step`` under the group rule: returns (state', reward, done,
    info); ``reset_pose`` (A, N, 3) and ``reset_goal`` (A, N, 2) are taken
    by the robots of every group that is done."""
    tr = env.transition(world, st.pose, st.dead, st.step, st.goal, action)
    live, stalled, reached = tr["live"], tr["stalled"], tr["reached"]
    terminal = tr["terminal"]
    w_real = tr["w"] * ~stalled
    reward = (torch.where(reached, 15.0, (st.dist - tr["dist"]) * 2.5)
              + torch.where(stalled, -15.0, 0.0)
              + torch.where(w_real.abs() > world.omega_thresh,
                            -0.1 * w_real.abs(), 0.0)) * live

    dead_after = st.dead | terminal
    group = members(world, dead_after.device)                   # (G, N)
    group_done = (dead_after[:, None, :] | ~group).all(dim=-1)  # (A, G)
    mask = (group_done[..., None] & group).any(dim=1)           # (A, N)
    m = mask[..., None]
    pose = torch.where(m, reset_pose, tr["pose"])
    goal = torch.where(m, reset_goal, st.goal)
    ep_now = st.ep_return + reward
    frame = env.lidar(world, pose)[:, :, None]
    hist = torch.where(mask[..., None, None], frame,
                       torch.cat([st.scan_hist[:, :, 1:], frame], dim=2))
    new = env.State(
        pose=pose, speed=torch.where(m, 0.0, tr["speed"]), goal=goal,
        dist=torch.where(mask, env.first_dist(world, pose, goal), tr["dist"]),
        step=torch.where(mask, 0, tr["steps"]).to(torch.int32),
        dead=dead_after & ~mask, scan_hist=hist,
        ep_return=torch.where(mask, 0.0, ep_now))
    info = {"result": tr["result"], "valid": live,
            "ep_return": torch.where(terminal, ep_now, 0.0),
            "reached": reached & live, "crashed": stalled & live}
    return new, reward, st.dead | terminal, info


#: A beam whose range (normalized: range / max_range - 0.5) differs from
#: the program's by more than this counts in ``frame_share``: 6 mm, far
#: above the rounding of a ray cast, far below a missed wall or robot.
FRAME_TOL = 1e-3

#: The parts of the state whose gap ``rollout`` takes, each as (A, N, ...)
#: of a field: metres, radians, metres, metres, (m/s, rad/s).
GAP_FIELDS = {"xy": lambda s: s.pose[..., :2], "heading":
              lambda s: s.pose[..., 2:], "goal": lambda s: s.goal,
              "dist": lambda s: s.dist[..., None], "speed": lambda s: s.speed}


def rollout(world: World, model: dict, p: dict, horizon: int, noise,
            resets, states: list):
    """``train.rollout`` with the group step, each step started from
    ``states[t]`` (dicts of every ``env.State`` field: the program's state
    before each step, and after the last).  Also returns, against the
    program's next states: the robot-steps whose ``dead`` or step counter
    differ, the largest gap of each of ``GAP_FIELDS`` over the others, the
    beams of the reference's frames, cast at the program's next poses,
    that differ from the program's newest frames by more than
    ``FRAME_TOL``, and the beams cast."""
    dev = noise.device
    forced = lambda t: env.State(**{k: v.to(dev) for k, v in
                                    states[t].items()})
    st = forced(0)
    a, n = st.pose.shape[:2]
    flat = lambda x: x.reshape(a * n, *x.shape[2:])
    keys = ("scans", "goal", "speed", "action", "logprob", "value",
            "reward", "done", "valid", "reached", "crashed")
    traj = {k: [] for k in keys}
    gaps = torch.zeros(len(GAP_FIELDS), device=dev)
    mismatch, flips, beams = 0, 0, 0
    with torch.no_grad():
        for t in range(horizon):
            scans, goal, speed = env.obs(st)
            value, mean, logstd = policy.forward(p, model, flat(scans),
                                                 flat(goal), flat(speed))
            raw = mean + torch.exp(logstd) * noise[t]
            for k, v in (("scans", scans), ("goal", goal), ("speed", speed),
                         ("action", raw.reshape(a, n, 2)),
                         ("logprob", policy.log_density(raw, mean, logstd)
                          .reshape(a, n)),
                         ("value", value.reshape(a, n))):
                traj[k].append(v)
            nxt, reward, done, info = step(world, st, raw.reshape(a, n, 2),
                                           *resets[t])
            traj["reward"].append(reward)
            traj["done"].append(done)
            for k in ("valid", "reached", "crashed"):
                traj[k].append(info[k])
            st = forced(t + 1)
            same = (nxt.dead == st.dead) & (nxt.step == st.step)
            mismatch += int((~same).sum())
            gaps = torch.maximum(gaps, torch.stack([
                torch.where(same[..., None], (part(nxt) - part(st)).abs(),
                            0.0).max() for part in GAP_FIELDS.values()]))
            frame = env.lidar(world, st.pose)
            flips += int(((frame - st.scan_hist[:, :, -1].float()).abs()
                          > FRAME_TOL).sum())
            beams += frame.numel()
        scans, goal, speed = env.obs(st)
        last = policy.forward(p, model, flat(scans), flat(goal),
                              flat(speed))[0][:, 0]
    traj = {k: torch.stack(v) for k, v in traj.items()}
    gaps = dict(zip(GAP_FIELDS, gaps.tolist()))
    return traj, last, gaps, mismatch, flips, beams


def follow(config: dict, world: World, ppo_cfg: dict, params0: dict,
           updates, states) -> dict:
    """``train.follow`` on the group step, each rollout following the
    program's states (``states``: for each update, its ``rollout``'s
    ``states``; the first is the arenas' start): ``len(updates)`` updates
    from ``params0``.  The same fields, each rollout's count of waiting
    robot-steps (dead, weight 0), its gaps of ``GAP_FIELDS`` and its
    mismatched robot-steps, and ``frame_share``, the share of the beams
    cast that differ from the program's frames."""
    model = config["model"]
    p = {k: v.detach().clone().requires_grad_() for k, v in params0.items()}
    adam = ppo.Adam(p, ppo_cfg["learning_rate"], **ppo_cfg["adam"])
    out = {"loss": [], "mean_loss": [], "counts": [], "waiting": [],
           "state_gap": [], "mismatch": []}
    first, flips, beams = {}, 0, 0
    for (noise, resets, perms), forced in zip(updates, states):
        traj, last, gaps, mismatch, flipped, cast = rollout(
            world, model, p, ppo_cfg["horizon"], noise, resets, forced)
        flips, beams = flips + flipped, beams + cast
        b = batch(traj, last, ppo_cfg["gamma"], ppo_cfg["lam"])
        out["counts"].append([int((traj["done"] & traj["valid"]).sum()),
                              int(traj["reached"].sum()),
                              int(traj["crashed"].sum())])
        out["waiting"].append(int((~traj["valid"]).sum()))
        out["state_gap"].append(gaps)
        out["mismatch"].append(mismatch)
        del traj
        mean_loss, parts = ppo.update(p, adam, model, ppo_cfg, b, perms,
                                      None if first else first.update)
        del b
        out["loss"].append(float(parts[0, 0]))
        out["mean_loss"].append(float(mean_loss))
    out["first_grad"] = first
    out["params"] = {k: v.detach() for k, v in p.items()}
    out["frame_share"] = flips / beams if beams else 1.0
    return out


def in_corridor(world: World, xy, eps: float = RULE_EPS):
    """(...) bool: ``xy`` (..., 2) lies in the corridor region, x in
    ``corridor["x"]`` and y in one of the bands ``corridor["y"]``."""
    c = world.raw["corridor"]
    x, y = xy[..., 0], xy[..., 1]
    ok = torch.zeros_like(x, dtype=torch.bool)
    for lo, hi in c["y"]:
        ok |= (y >= lo - eps) & (y <= hi + eps)
    return ok & (x >= c["x"][0] - eps) & (x <= c["x"][1] + eps)


def rule_breaks(world: World, poses: list, goals: list,
                stands: list) -> float:
    """The share of reset samples (pose (A, N, 3), goal (A, N, 2), drawn for
    robots standing at (A, N, 3)) that break the world's rule: a table
    robot's table pose and goal; a corridor robot's pose in the corridor,
    heading in [0, 2 pi], at least ``min_dist`` from where it stands, and
    its goal in the corridor at least ``min_dist`` from the pose.  1 where
    no sample was drawn."""
    if not poses:
        return 1.0
    pose, goal, stand = torch.cat(poses), torch.cat(goals), torch.cat(stands)
    w, eps = world.raw, RULE_EPS
    as_t = lambda x: torch.tensor(x, dtype=torch.float32, device=pose.device)
    table_pose, table_goal = as_t(w["table_poses"]), as_t(w["table_goals"])
    k = table_pose.shape[0]
    tables = (((pose[..., :k, :] - table_pose).abs() <= eps).all(dim=-1)
              & ((goal[..., :k, :] - table_goal).abs() <= eps).all(dim=-1))
    p, g, o = pose[..., k:, :], goal[..., k:, :], stand[..., k:, :2]
    dmin = w["corridor"]["min_dist"] - eps
    corridor = (in_corridor(world, p[..., :2]) & in_corridor(world, g)
                & (p[..., 2] >= 0.0) & (p[..., 2] <= 2.0 * math.pi + eps)
                & (torch.linalg.vector_norm(p[..., :2] - o, dim=-1) >= dmin)
                & (torch.linalg.vector_norm(g - p[..., :2], dim=-1) >= dmin))
    return float((~torch.cat([tables, corridor], dim=-1)).float().mean())
