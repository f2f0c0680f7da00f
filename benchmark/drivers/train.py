"""Training traffic: the window drives ``Trainer.train_step``, one PPO
update after another, with the program's own samplers.

Set-up builds one trainer at the configuration's preset and the traffic's
arena count, gives its policy the benchmark's initial weights and its
arenas the benchmark's first poses and goals, and drives it through the
checked updates with the benchmark's draws (action noise, reset samples,
minibatch order), which the reference follows, keeping the loss of each
update's first minibatch (its first optimizer step); then the warm-up updates
with the program's samplers, which also warm up those.  The warm-up keeps
a copy of every reset sample the program's ``Env.sample_pose_goal``
draws (the sampler the window runs at every step); after the window they
are held to the world's rule.  The window goes on from that same state.  A unit is one update: horizon x arenas x robots
robot-steps, ended by the trainer's own host read of its metrics.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch

from benchmark import check, traffic
from benchmark.reference import train as ref_train
from benchmark.reference import world as ref_world

#: Updates on the benchmark's draws that the reference follows.
CHECKED_UPDATES = 3
#: Updates with the program's samplers, after the checked ones.
WARMUP_UPDATES = 1
#: Updates in the traced window of a ``--trace 1`` run.
TRACED_UNITS = 2


@contextlib.contextmanager
def first_loss(into: list):
    """While active, ``into`` gets the loss of the first minibatch that
    the program's ``ppo_loss`` computes: the loss of its first optimizer
    step, before any parameter has moved."""
    from rl_collision_avoidance_torch.algo import ppo

    loss_fn = ppo.ppo_loss

    def loss(*args, **kwargs):
        out = loss_fn(*args, **kwargs)
        if not into:
            into.append(float(out[0].detach()))
        return out

    ppo.ppo_loss = loss
    try:
        yield
    finally:
        ppo.ppo_loss = loss_fn


def ppo_settings(cell) -> dict:
    ppo = dict(cell.config["ppo"])
    ppo["batch_size"] = ppo["minibatch_per_arena"] * cell.traffic["arenas"]
    return ppo


class Session:
    def __init__(self, cell, seed: int, device, policy_dtype=torch.float32):
        from rl_collision_avoidance_torch.algo.ppo import PPOConfig
        from rl_collision_avoidance_torch.train import TrainConfig, Trainer

        clock = time.perf_counter()
        self.phases = {}

        def phase(name):
            nonlocal clock
            now = time.perf_counter()
            self.phases[name] = now - clock
            clock = now

        self.cell, self.device = cell, torch.device(device)
        t = cell.traffic
        self.world = cell.config["worlds"][t["world"]]
        self.ppo = ppo = ppo_settings(cell)
        arenas = t["arenas"]
        cfg = TrainConfig(
            world=self.world["name"], n_arenas=arenas,
            horizon=ppo["horizon"], gamma=ppo["gamma"], lam=ppo["lam"],
            ppo=PPOConfig(batch_size=ppo["batch_size"],
                          epochs=ppo["epochs"],
                          clip_value=ppo["clip_value"],
                          coeff_entropy=ppo["coeff_entropy"],
                          value_coeff=ppo["value_coeff"],
                          learning_rate=ppo["learning_rate"],
                          logstd_min=ppo["logstd_min"]),
            seed=seed, policy_dtype=policy_dtype)
        self.trainer = Trainer(cfg, device=self.device)
        phase("trainer")
        state = self.trainer.init_state()
        phase("init_state")
        gen = traffic.generator(seed, self.device)
        self.params0 = traffic.weights(cell.config["model"], gen)
        state.policy.load_state_dict(self.params0)
        self.start = traffic.pose_goal(self.world, arenas, gen)
        env_state, _ = self.trainer.env.reset(arenas, *self.start)
        state = dataclasses.replace(state, env_state=env_state)
        phase("inputs")

        self.first = {}
        names = {p: k for k, p in state.policy.named_parameters()}
        beta1 = ppo["adam"]["beta1"]

        def first_gradient(optimizer, args, kwargs):
            # after Adam's first step its first moment is (1 - beta1) g
            if not self.first:
                self.first.update({
                    names[p]: optimizer.state[p]["exp_avg"] / (1.0 - beta1)
                    for group in optimizer.param_groups
                    for p in group["params"]})

        hook = state.optimizer.register_step_post_hook(first_gradient)
        self.draws, self.losses, self.counts = [], [], []
        self.mean_losses = []
        for _ in range(CHECKED_UPDATES):
            draws = traffic.update_draws(self.world, ppo, arenas, gen)
            seen = []
            with first_loss(seen):
                state, m = self.trainer.train_step(state, *draws)
            self.draws.append(draws)
            self.losses.append(seen[0] if seen else math.nan)
            self.mean_losses.append(m["policy_loss"]
                                    + ppo["value_coeff"] * m["value_loss"]
                                    - ppo["coeff_entropy"] * m["entropy"])
            self.counts.append([int(m[k]) for k in ("episodes", "reached",
                                                     "crashed")])
        hook.remove()
        phase("checked")
        self.params_end = {k: v.detach().clone() for k, v in
                           state.policy.state_dict().items()}
        env, self.resets = self.trainer.env, []
        sampler = env.sample_pose_goal

        def sample(*args, **kwargs):
            pose, goal = sampler(*args, **kwargs)
            self.resets.append((pose.clone(), goal.clone()))
            return pose, goal

        env.sample_pose_goal = sample
        try:
            for _ in range(WARMUP_UPDATES):
                state, _ = self.trainer.train_step(state)
        finally:
            del env.sample_pose_goal
        phase("warmup")
        self.state = state
        self.robot_steps = ppo["horizon"] * arenas * self.world["n_robots"]

    def unit(self, positions: list | None = None):
        """One update; ``positions`` collects the poses of its env steps
        (references, no device work)."""
        env = self.trainer.env
        if positions is not None:
            env_step = env.step

            def step(state, *args, **kwargs):
                positions.append(state.pose)
                return env_step(state, *args, **kwargs)

            env.step = step
        try:
            self.state, m = self.trainer.train_step(self.state)
        finally:
            if positions is not None:
                del env.step
        return not all(math.isfinite(v) for v in m.values())

    def tally(self, records) -> dict:
        return {"units": len(records),
                "robot_steps": self.robot_steps * len(records),
                "env_steps": self.ppo["horizon"] * len(records),
                "failed": sum(map(bool, records))}

    def readings(self, records) -> dict:
        """Frees the program's state, runs the reference over the checked
        updates, and returns the compared numbers."""
        del self.trainer, self.state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        world = ref_world.load(self.cell.config, self.cell.traffic["world"],
                               self.device)
        ref = ref_train.follow(self.cell.config, world, self.ppo,
                               self.params0, self.start, self.draws)
        out = check.train_readings(self.losses, ref["loss"], self.first,
                                   ref["first_grad"], self.params0,
                                   self.params_end, ref["params"])
        out["reset_rule_share"] = ref_world.rule_breaks(
            world, [p for p, _ in self.resets], [g for _, g in self.resets])
        out["resets_drawn"] = len(self.resets)
        out["mean_loss_gaps"] = [abs(a - b) / abs(b) for a, b in
                                 zip(self.mean_losses, ref["mean_loss"])]
        out["counts"] = {"program": self.counts, "reference": ref["counts"]}
        return out
