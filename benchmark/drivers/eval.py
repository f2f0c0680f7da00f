"""Eval traffic: the window drives ``eval/circle.py::run_episodes``, one
circle-swap call after another, as the results pipeline's sweep runs it.

Set-up loads the traffic's trained weights into a ``CNNPolicy`` on the
card, builds the eval world's env and runs one short warm-up call.  Each
call draws its start jitter from the seed as it starts (arena 0 of every
call is the exact ring).  A unit is one call: its steps are what the
program's loop ran, up to the first check after every robot has a
result, or all ``max_steps``.  Nothing watches the window's calls.  Once
it has closed, the program runs its first ``FOLLOWED_CALLS`` calls again
with their jitter, and the driver copies what the program hands
``Env.step`` in arenas drawn from the seed (poses, speeds, finished flags
and actions).  The reference follows those arenas step by step from the
copied states, and each robot's answers (its first result and its step)
are compared with the window's.
"""
from __future__ import annotations

import math
import time

import torch

from benchmark import check, traffic
from benchmark.reference import circle as ref_circle
from benchmark.reference import world as ref_world

#: Steps of the warm-up call, at the cell's arena count.
WARMUP_STEPS = 50
#: The window's calls that are run again and followed by the reference.
FOLLOWED_CALLS = 2
#: Arenas followed, over the followed calls together.
CHECKED_ARENAS = 8
#: Calls in the traced window of a ``--trace 1`` run.
TRACED_UNITS = 1


class Session:
    def __init__(self, cell, seed: int, device, policy_dtype=torch.float32):
        from rl_collision_avoidance_torch.engine.env import Env
        from rl_collision_avoidance_torch.eval import circle
        from rl_collision_avoidance_torch.models import CNNPolicy
        from rl_collision_avoidance_torch.worlds import get_world

        t0 = time.perf_counter()
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        t, model = cell.traffic, cell.config["model"]
        self.world = cell.config["worlds"][t["world"]]
        self.arenas, self.n = t["arenas"], self.world["n_robots"]
        self.weights = traffic.npz_weights(cell.root / t["weights"], model,
                                           self.device)
        self.policy = CNNPolicy(model["frames"], model["beams"],
                                policy_dtype).to(self.device).eval()
        self.policy.load_state_dict(self.weights)
        self.env = Env(get_world(self.world["name"]), device=self.device,
                       seed=seed)
        self.run_episodes, self.check_every = (circle.run_episodes,
                                               circle.CHECK_EVERY)
        self.gen = traffic.generator(seed, self.device)
        warm = self.draw()
        t1 = time.perf_counter()
        self.run_episodes(self.policy, self.env, self.arenas, WARMUP_STEPS,
                          warm)
        self.phases = {"objects": t1 - t0, "warmup": time.perf_counter() - t1}
        self.calls, self.jitter = [], []

    def draw(self) -> torch.Tensor:
        return traffic.offsets(self.arenas, self.n,
                               self.cell.traffic["pose_noise_m"], self.gen)

    def call(self, jitter, step=None):
        """``run_episodes`` from ``jitter``; ``step(state, action, out)``
        sees each env step."""
        if step is not None:
            env_step = self.env.step

            def stepped(state, action, *args, **kwargs):
                out = env_step(state, action, *args, **kwargs)
                step(state, action, out)
                return out

            self.env.step = stepped
        try:
            return self.run_episodes(self.policy, self.env, self.arenas,
                                     self.cell.traffic["max_steps"], jitter)
        finally:
            if step is not None:
                del self.env.step

    def unit(self, positions: list | None = None):
        """One call; ``positions`` collects the poses of its env steps."""
        self.jitter.append(self.draw())
        seen = (None if positions is None else
                lambda state, action, out: positions.append(state.pose))
        done, first, _ = self.call(self.jitter[-1], seen)
        self.calls.append((done, first))
        return len(self.calls) - 1

    def steps(self, k: int) -> int:
        """Steps call ``k``'s loop ran."""
        done, first = self.calls[k]
        max_steps = self.cell.traffic["max_steps"]
        if bool((first == 0).any()):
            return max_steps
        last = int(done.max())
        return min(max_steps, -(-last // self.check_every) * self.check_every)

    def tally(self, records) -> dict:
        steps = [self.steps(k) for k in records]
        return {"units": len(records),
                "robot_steps": sum(steps) * self.arenas * self.n,
                "env_steps": sum(steps), "failed": 0}

    def sample(self, records) -> dict:
        """{call: [arenas]}: of each followed call of the window, its
        share of ``CHECKED_ARENAS``, drawn from the seed."""
        gen = torch.Generator().manual_seed(self.seed)
        calls = [k for k in records if k < FOLLOWED_CALLS]
        each = min(self.arenas, -(-CHECKED_ARENAS // max(len(calls), 1)))
        return {k: sorted(torch.randperm(self.arenas, generator=gen)[:each]
                          .tolist()) for k in calls}

    def follow(self, k: int, arenas: list) -> dict:
        """Call ``k`` run again by the program, with copies of its states
        and actions in ``arenas`` at every env step."""
        rows = torch.tensor(arenas, device=self.device)
        seen, last = [], []

        def step(state, action, out):
            seen.append([x.index_select(0, rows).clone() for x in
                         (state.pose, state.speed, state.dead, action)])
            last[:] = [x.index_select(0, rows).clone() for x in
                       (out[0].pose, out[0].speed, out[0].dead)]

        done, first, _ = self.call(self.jitter[k], step)
        return {"seen": seen, "last": last, "rerun": (done, first)}

    def readings(self, records) -> dict:
        """Runs the followed calls again, frees the program, follows the
        copies with the reference, and returns the compared numbers."""
        sample = self.sample(records)
        followed = {k: self.follow(k, arenas) for k, arenas in sample.items()}
        del self.policy, self.env
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        world = ref_world.load(self.cell.config, self.cell.traffic["world"],
                               self.device)
        gaps = {"action_gap": 0.0, "state_gap": 0.0}
        mismatched, rerun, robots = 0, 0, 0
        for k, arenas in sample.items():
            seen, last = followed[k]["seen"], followed[k]["last"]
            if not seen:         # the program stepped without ``Env.step``
                return check.eval_readings(math.inf, math.inf, 1.0)
            pick = lambda i: torch.stack([s[i] for s in seen])
            poses = torch.cat([pick(0), last[0][None]])
            speeds = torch.cat([pick(1), last[1][None]])
            deads = torch.cat([pick(2), last[2][None]])
            offsets = self.jitter[k][arenas].clone()
            offsets[torch.tensor(arenas) == 0] = 0.0   # arena 0: the ring
            out = ref_circle.follow(self.cell.config, world, self.weights,
                                    offsets, poses, speeds, deads, pick(3))
            for name in gaps:
                gaps[name] = max(gaps[name], out[name])
            done, first = (x[arenas] for x in self.calls[k])
            mismatched += int(((first != out["first_result"])
                               | (done != out["done_step"])).sum())
            rdone, rfirst = (x[arenas] for x in followed[k]["rerun"])
            rerun += int(((first != rfirst) | (done != rdone)).sum())
            robots += first.numel()
        return {**check.eval_readings(gaps["action_gap"], gaps["state_gap"],
                                      mismatched / max(robots, 1)),
                "robots": robots, "rerun_mismatch": rerun / max(robots, 1),
                "calls_followed": {str(k): v for k, v in sample.items()}}
