"""The reference's circle-swap evaluation (``circle_test.py``), following
the program step by step from the program's own states.

Every robot acts with the policy's mean action, clipped; a finished robot
stops translating and keeps steering; each robot's first result and its
step are kept.  The swap's crowd amplifies a rounding difference into a
different trajectory within a call, so the reference does not run its own
trajectory: at each step t it takes the program's poses, speeds and
finished flags, builds the observation itself (its lidar at the poses of
steps t-2, t-1 and t, the goal in the body frame, the speed), computes
the mean action, and makes the step with the program's action.  Steps are
independent given the states, so they run together, in chunks.
"""
from __future__ import annotations

import torch

from . import env, policy
from .world import World, tables

#: Steps of one chunk of the policy's forward.
STEPS = 32


def follow(config: dict, world: World, p: dict, offsets, poses, speeds,
           deads, actions) -> dict:
    """Arenas that started from the ring jittered by ``offsets`` (K, N, 2);
    the program's states before each of its T steps and after the last,
    ``poses`` (T + 1, K, N, 3), ``speeds`` (T + 1, K, N, 2), ``deads``
    (T + 1, K, N), and its actions (T, K, N, 2).  Returns the largest gap
    of an action and of a state from the reference's, and each robot's
    first result and its step, (K, N) each, as the program's states and
    actions give them."""
    t, k, n = actions.shape[:3]
    ring, goal = tables(world, actions.device)
    start = ring.expand(k, n, 3).clone()
    start[..., :2] += offsets
    frames = env.lidar(world, poses[:-1].reshape(t * k, n, 3)).view(
        t, k, n, -1)
    action_gap = 0.0
    for lo in range(0, t, STEPS):
        idx = torch.arange(lo, min(t, lo + STEPS), device=actions.device)
        hist = torch.stack([frames[(idx - back).clamp_min(0)]
                            for back in (2, 1, 0)], dim=3)   # (s, K, N, F, B)
        pose = poses[idx]
        with torch.no_grad():
            _, mean, _ = policy.forward(
                p, config["model"], hist.flatten(0, 2),
                env.local_goal(pose, goal).flatten(0, 2),
                speeds[idx].flatten(0, 2), actor_only=True)
        mean = torch.stack([mean[:, 0].clamp(0.0, 1.0),
                            mean[:, 1].clamp(-1.0, 1.0)], dim=-1)
        action_gap = max(action_gap, float((mean - actions[idx].flatten(0, 2))
                                           .abs().max()))
    steps = torch.cumsum((~deads[:-1]).to(torch.int32), dim=0) \
        - (~deads[:-1]).to(torch.int32)                  # live steps before t
    tr = env.transition(world, poses[:-1].reshape(t * k, n, 3),
                        deads[:-1].reshape(t * k, n),
                        steps.reshape(t * k, n), goal,
                        actions.reshape(t * k, n, 2))
    dead_next = deads[:-1] | tr["terminal"].view(t, k, n)
    state_gap = max(float((poses[0] - start).abs().max()),
                    float((tr["pose"].view(t, k, n, 3) - poses[1:])
                          .abs().max()),
                    float((tr["speed"].view(t, k, n, 2) - speeds[1:])
                          .abs().max()),
                    float((dead_next != deads[1:]).any()))
    result = tr["result"].view(t, k, n)
    ended = result != env.RUNNING
    step = ended.to(torch.uint8).argmax(dim=0)           # first ended step
    first = torch.where(ended.any(dim=0),
                        result.gather(0, step[None])[0], env.RUNNING)
    done = torch.where(ended.any(dim=0), step + 1, 0)
    return {"action_gap": action_gap, "state_gap": state_gap,
            "first_result": first.to(torch.int32),
            "done_step": done.to(torch.int32)}
