"""Stage-2 training traffic: ``drivers/train.py``'s units on a world whose
robots reset by scenario group and whose corridor robots draw fresh poses
from the corridor sampler (``reference/groups.py``).

Set-up builds one trainer at the configuration's preset and the traffic's
arena count, gives its policy the traffic's ``weights`` (a JAX npz under
``benchmark/``; seeded random ones where the traffic names none) and its
arenas the benchmark's first poses and goals, and drives it through the
checked updates on the benchmark's draws (action noise, reset samples,
minibatch order), keeping a host copy of the env's state before each
acting step and after the last, which the reference follows step by step
(``reference/groups.py``: the trained policy is chaotic in these
scenarios); then the warm-up update with the program's own samplers.  The
draws follow the stage-2 rule: a table robot gets its table pose and goal,
a corridor robot a pose uniform in the corridor and, as its goal, the
first of the rule's candidates that lies ``min_dist`` from that pose.  A draw cannot know where a robot will
stand, so it leaves out the rule's distance from the current position;
the program and the reference get the same pairs, and nothing compared
depends on it.  The reference's next state is held to the program's at
every checked step: ``mismatch_share``, the robot-steps whose ``dead`` or
step counter differ (a group reset made or left out), and ``state_gap``,
the largest gap of pose, heading, goal, distance and speed over the
others in the first checked update.  The warm-up keeps every sample the program's
``Env.sample_pose_goal`` draws, with the poses it was drawn for, and they
are held to the whole rule (``reset_rule_share``).  The window goes on
from that state.  A unit is one update, as in ``drivers/train.py``; its
record also carries the update's robot-steps spent dead, waiting for the
group (the trainer's ``waiting`` count, where the program has one), which
the tally gives as a share of the robot-steps.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from benchmark import check, traffic
from benchmark.drivers import train
from benchmark.reference import groups as ref_groups
from benchmark.reference import world as ref_world

#: Updates on the benchmark's draws that the reference follows.
CHECKED_UPDATES = 3
#: Updates with the program's samplers, after the checked ones.
WARMUP_UPDATES = 1
#: Updates in the traced window of a ``--trace 1`` run.
TRACED_UNITS = 2


def corridor_xy(corridor: dict, u_x, u_y):
    """(..., 2) points uniform in the corridor from two uniforms: x over
    ``corridor["x"]``, y over the bands ``corridor["y"]`` laid end to end
    from the top of the first (``stage_world2.py``: u <= 0.4 gives y in
    [-5, -1], else in [-19, -13])."""
    (x0, x1), bands = corridor["x"], corridor["y"]
    heights = [hi - lo for lo, hi in bands]
    h = u_y * sum(heights)
    y, at = None, sum(heights)
    for (lo, hi), height in zip(reversed(bands), reversed(heights)):
        at -= height
        band = hi - (h - at)
        y = band if y is None else torch.where(h <= at + height, band, y)
    return torch.stack([x0 + (x1 - x0) * u_x, y], dim=-1)


def pose_goal(world: dict, arenas: int, gen: torch.Generator):
    """A fresh (pose (A, N, 3), goal (A, N, 2)) for every robot by the
    stage-2 rule, bar the distance from where a robot stands."""
    dev, corridor = gen.device, world["corridor"]
    table_pose = torch.tensor(world["table_poses"], device=dev)
    table_goal = torch.tensor(world["table_goals"], device=dev)
    k = table_pose.shape[0]
    shape = (arenas, world["n_robots"] - k)
    u = torch.rand((3, *shape), generator=gen, device=dev)
    xy = corridor_xy(corridor, u[0], u[1])
    v = torch.rand((2, *shape, corridor["candidates"]), generator=gen,
                   device=dev)
    cand = corridor_xy(corridor, v[0], v[1])
    far = torch.linalg.vector_norm(cand - xy[..., None, :], dim=-1) \
        >= corridor["min_dist"]
    first = far.to(torch.uint8).argmax(dim=-1)
    goal = torch.gather(cand, -2, first[..., None, None].expand(
        *first.shape, 1, 2))[..., 0, :]
    pose = torch.cat([xy, 2.0 * math.pi * u[2][..., None]], dim=-1)
    return (torch.cat([table_pose.expand(arenas, k, 3), pose], dim=1),
            torch.cat([table_goal.expand(arenas, k, 2), goal], dim=1))


def update_draws(world: dict, ppo: dict, arenas: int, gen: torch.Generator):
    """``traffic.update_draws`` with the stage-2 reset samples."""
    horizon, e = ppo["horizon"], arenas * world["n_robots"]
    noise = torch.randn((horizon, e, 2), generator=gen, device=gen.device)
    resets = [pose_goal(world, arenas, gen) for _ in range(horizon)]
    used = horizon * e // ppo["batch_size"] * ppo["batch_size"]
    perms = torch.stack([torch.randperm(horizon * e, generator=gen,
                                        device=gen.device)[:used]
                         for _ in range(ppo["epochs"])])
    return noise, resets, perms


def snapshot(state) -> dict:
    """Every field of an ``EnvState``, copied to the host: the checked
    updates' states would otherwise hold 1.7 GB of the card's memory."""
    return {f.name: getattr(state, f.name).to("cpu", copy=True)
            for f in dataclasses.fields(state)}


class Record:
    """One update: whether a metric came back not finite (its truth), and
    its waiting robot-steps (None where the program does not count them).
    A plain class: the harness loads this file outside ``sys.modules``,
    where a dataclass cannot resolve its annotations."""

    def __init__(self, failed: bool, waiting: float | None):
        self.failed, self.waiting = failed, waiting

    def __bool__(self) -> bool:
        return self.failed


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
        self.ppo = ppo = train.ppo_settings(cell)
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
        model = cell.config["model"]
        self.params0 = (traffic.npz_weights(cell.root / t["weights"], model,
                                            self.device)
                        if "weights" in t else traffic.weights(model, gen))
        state.policy.load_state_dict(self.params0)
        env_state, _ = self.trainer.env.reset(
            arenas, *pose_goal(self.world, arenas, gen))
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
        env = self.trainer.env
        env_step = env.step
        self.draws, self.losses, self.counts = [], [], []
        self.mean_losses, self.waiting, self.states = [], [], []
        for _ in range(CHECKED_UPDATES):
            draws = update_draws(self.world, ppo, arenas, gen)
            seen, states = [], []

            def step(env_state, *args, **kwargs):
                states.append(snapshot(env_state))
                return env_step(env_state, *args, **kwargs)

            env.step = step
            try:
                with train.first_loss(seen):
                    state, m = self.trainer.train_step(state, *draws)
            finally:
                del env.step
            states.append(snapshot(state.env_state))
            self.states.append(states)
            self.draws.append(draws)
            self.losses.append(seen[0] if seen else math.nan)
            self.mean_losses.append(m["policy_loss"]
                                    + ppo["value_coeff"] * m["value_loss"]
                                    - ppo["coeff_entropy"] * m["entropy"])
            self.counts.append([int(m[k]) for k in ("episodes", "reached",
                                                     "crashed")])
            self.waiting.append(m.get("waiting"))
        hook.remove()
        phase("checked")
        self.params_end = {k: v.detach().clone() for k, v in
                           state.policy.state_dict().items()}
        self.resets = []
        sampler = env.sample_pose_goal

        def sample(n_arenas, cur_pose=None):
            pose, goal = sampler(n_arenas, cur_pose)
            stand = torch.zeros_like(pose) if cur_pose is None else cur_pose
            self.resets.append((pose.clone(), goal.clone(), stand.clone()))
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

    def unit(self, positions: list | None = None) -> Record:
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
        return Record(not all(math.isfinite(v) for v in m.values()),
                      m.get("waiting"))

    def tally(self, records) -> dict:
        out = {"units": len(records),
               "robot_steps": self.robot_steps * len(records),
               "env_steps": self.ppo["horizon"] * len(records),
               "failed": sum(map(bool, records))}
        if records and all(r.waiting is not None for r in records):
            out["waiting_share"] = (sum(r.waiting for r in records)
                                    / out["robot_steps"])
        return out

    def readings(self, records) -> dict:
        """Frees the program's state, runs the reference over the checked
        updates, and returns the compared numbers."""
        del self.trainer, self.state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        world = ref_world.load(self.cell.config, self.cell.traffic["world"],
                               self.device)
        ref = ref_groups.follow(self.cell.config, world, self.ppo,
                                self.params0, self.draws, self.states)
        out = check.train_readings(self.losses, ref["loss"], self.first,
                                   ref["first_grad"], self.params0,
                                   self.params_end, ref["params"])
        poses, goals, stands = ([list(x) for x in zip(*self.resets)]
                                or [[], [], []])
        out["reset_rule_share"] = ref_groups.rule_breaks(world, poses, goals,
                                                         stands)
        out["resets_drawn"] = len(self.resets)
        out["mean_loss_gaps"] = [abs(a - b) / abs(b) for a, b in
                                 zip(self.mean_losses, ref["mean_loss"])]
        out["counts"] = {"program": self.counts, "reference": ref["counts"]}
        out["waiting"] = {"program": self.waiting,
                          "reference": ref["waiting"]}
        out["frame_share"] = ref["frame_share"]
        # the first update's steps alone: both sides act with the same
        # parameters there, so the gap is the step's rounding; later
        # actions part by Adam's rounding (``change_gap``)
        out["state_gap"] = max(ref["state_gap"][0].values())
        out["state_gaps"] = ref["state_gap"]
        out["mismatch_share"] = (sum(ref["mismatch"])
                                 / (len(ref["mismatch"]) * self.robot_steps))
        out["mismatch"] = ref["mismatch"]
        return out
