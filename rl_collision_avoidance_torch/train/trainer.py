"""The training loop: rollout, bootstrap, GAE and PPO, one update at a time.

Counterpart of ``rl_collision_avoidance_tpu/train/trainer.py``, for the
curriculum's three presets (stage 1, stage 2, the circle fine-tune), in one
process or in several (``parallel/dist.py``).  One
:meth:`Trainer.train_step` is one reference "update"
(``ppo_stage1.py:39-130``): ``horizon`` acting steps of every robot of every
arena, the bootstrap value at the horizon, GAE over (T, E), advantage
normalization, an arena-major flatten and the PPO epochs.  A dead robot's
steps (stage 2's finished robots waiting for their group) stay in the
rollout as in the JAX package: ``done`` cuts GAE there, they count in the
advantage normalization, and they train with weight 0.  On the CUDA card
the policy runs through the trunk forward kernel in the rollout and through
the forward and backward kernels in the update; the env step runs the lidar
kernel.  Phases are marked with ``utils/profiling.span`` so that the
benchmark and the ``--profile DIR`` traces can split the device time: each
acting step is ``act_step``, its policy forward ``act_policy``; the first
observation and the bootstrap stay directly in ``rollout``, so that span's
device-side extent still runs from the first step to the bootstrap.

Mixed precision, as the JAX trainer's: ``policy_dtype=torch.bfloat16``
runs the policy in bf16 (``CNNPolicy(dtype=...)``: the trunk kernels' bf16
mode and a bf16 dense tail) in the rollout, the bootstrap and the PPO
update, while parameters, Adam state and the PPO losses stay float32;
``obs_store_dtype=torch.bfloat16`` stores the env's scan history and the
rollout buffer's scans in bf16.

Multi-process training, as the JAX trainer's arenas sharded over a mesh:
in a process group of W ranks each rank steps its own A / W arenas
(``parallel.arena_range``) with generators seeded from (seed, rank), rank
0's policy is broadcast at init, the advantages are normalized over the
whole rollout (gathered, then each rank keeps its slice), ``ppo_update``
sums the gradients over the ranks, and the metrics are global.  Without a
group (or with one rank) every step computes what one process computes.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..algo import gae
from ..algo.ppo import (Batch, PPOConfig, normalize_shard_advantages,
                        ppo_update)
from ..engine.env import Env, EnvState
from ..models import CNNPolicy, distributions
from ..parallel import dist
from ..utils import graphs
from ..utils.device import resolve_device
from ..utils.profiling import StepTimer, span, trace
from ..worlds import get_world


#: Updates that ``Trainer.train(profile_dir=...)`` traces, as the JAX
#: trainer's ``profile_updates`` default.
PROFILE_UPDATES = 3


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters; defaults = stage-1 reference (ppo_stage1.py:22-35)."""
    world: str = "stage1"
    n_arenas: int = 1          # arenas (replicas of the world), all ranks
    horizon: int = 128
    gamma: float = 0.99
    lam: float = 0.95
    ppo: PPOConfig = PPOConfig(batch_size=1024, epochs=2, clip_value=0.1,
                               coeff_entropy=5e-4, learning_rate=5e-5)
    seed: int = 0
    max_updates: int = 2000
    # The policy's compute dtype: float32, or bfloat16 (mixed precision;
    # parameters and Adam state stay float32).
    policy_dtype: torch.dtype = torch.float32
    # Storage dtype of the lidar frames (the env's scan history and the
    # rollout buffer, the largest training tensor: horizon x arenas x robots
    # x 3 x 512); None keeps float32.
    obs_store_dtype: torch.dtype | None = None

    @staticmethod
    def stage1(**kw) -> "TrainConfig":
        """Stage-1 hyperparameters (ppo_stage1.py:22-35).

        The minibatch size scales with the arena count so the number of
        gradient steps per update stays at the reference's (PPO over-replays
        and collapses otherwise); pass an explicit ``ppo`` to override.
        """
        a = kw.get("n_arenas", 1)
        kw.setdefault("ppo", PPOConfig(batch_size=1024 * a, epochs=2,
                                       clip_value=0.1, coeff_entropy=5e-4,
                                       learning_rate=5e-5))
        return TrainConfig(**kw)

    @staticmethod
    def stage2(**kw) -> "TrainConfig":
        """Stage-2 hyperparameters (ppo_stage2.py:22-35); the minibatch
        scales with the arena count as in :meth:`stage1`."""
        a = kw.get("n_arenas", 1)
        kw.setdefault("world", "stage2")
        kw.setdefault("ppo", PPOConfig(batch_size=512 * a, epochs=4,
                                       clip_value=0.1, coeff_entropy=5e-4,
                                       learning_rate=5e-5))
        return TrainConfig(**kw)

    @staticmethod
    def circle_ft(**kw) -> "TrainConfig":
        """Stage 3: fine-tune on the jittered 50-robot circle swap (world
        ``circle_train``), stage-2 PPO settings plus a logstd floor of -2
        (the JAX package's preset: its stage-2 run's entropy collapses, so
        the floor keeps exploration for the new task).  128 x 50 x A
        samples an update in minibatches of 640 A: 10 minibatches x 4
        epochs."""
        a = kw.get("n_arenas", 1)
        kw.setdefault("world", "circle_train")
        kw.setdefault("ppo", PPOConfig(batch_size=640 * a, epochs=4,
                                       clip_value=0.1, coeff_entropy=5e-4,
                                       learning_rate=5e-5, logstd_min=-2.0))
        return TrainConfig(**kw)

    @staticmethod
    def for_world(world: str, **kw) -> "TrainConfig":
        """The preset that trains on ``world`` (stage 1's for any other
        world), with ``world`` set."""
        name = next((n for n, f in PRESETS.items() if f().world == world),
                    "stage1")
        return PRESETS[name](world=world, **kw)


#: The training presets by stage name, as the CLI's commands run them.
PRESETS = {"stage1": TrainConfig.stage1, "stage2": TrainConfig.stage2,
           "circle_ft": TrainConfig.circle_ft}


@dataclasses.dataclass
class TrainState:
    """What one update reads and writes.  ``policy`` and ``optimizer`` are
    updated in place by :meth:`Trainer.train_step`."""
    policy: CNNPolicy
    optimizer: torch.optim.Adam
    env_state: EnvState      # leading axis = arenas
    generator: torch.Generator  # action noise and minibatch order
    update: int


class _Acting:
    """The acting step outside ``Env.step`` over static tensors, as
    ``utils/graphs.Step`` captures it on the card: the policy on ``scans``,
    ``goal`` and ``speed`` (an observation's shapes), the Gaussian sample
    on the standard-normal ``noise`` (E, 2), its log-prob, and the writes
    of the observation, action, log-prob and value into ``traj`` at the
    step index ``t`` (on the device), which the step advances.  ``step()``
    returns the (A, N, 2) raw action."""

    def __init__(self, policy: CNNPolicy, obs, horizon: int):
        a, n = obs.scans.shape[:2]
        device = obs.scans.device
        self.scans, self.goal, self.speed = (
            torch.zeros(x.shape, dtype=x.dtype, device=device)
            for x in (obs.scans, obs.goal, obs.speed))
        self.noise = torch.zeros((a * n, 2), device=device)
        self.t = torch.zeros((1,), dtype=torch.long, device=device)
        buf = lambda *shape, dtype=torch.float32: torch.empty(
            (horizon, a, n, *shape), dtype=dtype, device=device)
        self.traj = {"scans": buf(*obs.scans.shape[2:],
                                  dtype=obs.scans.dtype),
                     "goal": buf(2), "speed": buf(2), "action": buf(2),
                     "logprob": buf(), "value": buf(), "reward": buf(),
                     **{k: buf(dtype=torch.bool) for k in
                        ("done", "valid", "reached", "crashed")},
                     "ep_return": buf()}
        flat = lambda x: x.reshape(a * n, *x.shape[2:])

        def step():
            value, mean, logstd = policy(flat(self.scans), flat(self.goal),
                                         flat(self.speed))
            raw = distributions.sample(mean, logstd, self.noise)
            logprob = distributions.log_normal_density(raw, mean, logstd)
            for k, x in (("scans", self.scans), ("goal", self.goal),
                         ("speed", self.speed), ("action", raw),
                         ("logprob", logprob), ("value", value)):
                into = self.traj[k]
                into.index_copy_(0, self.t, x.reshape(1, *into.shape[1:]))
            # modulo the horizon: the capture's warm-up runs steps too
            self.t.add_(1).remainder_(horizon)
            return raw.reshape(a, n, 2)

        self.step = graphs.Step(step, device)


class Trainer:
    """Owns the env and runs updates on one device (the CUDA card unless
    ``device`` says otherwise).  In a process group it is this rank's
    trainer: its env holds the rank's share of ``cfg.n_arenas`` (which W
    must divide)."""

    def __init__(self, cfg: TrainConfig, device=None):
        self.cfg = cfg
        self.spec = get_world(cfg.world)
        self.device = resolve_device(device)
        self.world = dist.world_size()
        lo, hi = dist.arena_range(cfg.n_arenas)
        self.n_local = hi - lo
        self.env = Env(self.spec, device=self.device,
                       seed=dist.rank_seed(cfg.seed),
                       obs_dtype=cfg.obs_store_dtype)
        # (key, _Acting) of the last rollout on the card: see _acting_for
        self._acting = None

    def _policy_and_optimizer(self, seed: int):
        """A policy with PyTorch's default init from a generator seeded by
        ``seed``, and Adam with optax's ``adam`` defaults
        (``trainer.py:142``)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            policy = CNNPolicy(self.spec.laser_frames, self.spec.n_beams,
                               self.cfg.policy_dtype)
        policy = policy.to(self.device)
        optimizer = torch.optim.Adam(policy.parameters(),
                                     lr=self.cfg.ppo.learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
        return policy, optimizer

    def init_state(self, seed: int | None = None) -> TrainState:
        """Fresh arenas, policy and Adam, all drawn from ``seed``
        (``cfg.seed``): the policy from ``seed`` and broadcast from rank 0,
        the arenas and the trainer's draws from this rank's seeds."""
        seed = self.cfg.seed if seed is None else seed
        policy, optimizer = self._policy_and_optimizer(seed)
        dist.broadcast_module(policy)
        self.env.generator.manual_seed(dist.rank_seed(seed))
        env_state, _ = self.env.reset(self.n_local)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(dist.rank_seed(seed + 1))
        return TrainState(policy=policy, optimizer=optimizer,
                          env_state=env_state, generator=generator, update=0)

    def state_dict(self, state: TrainState) -> dict:
        """Everything an exact resume needs, for ``utils/checkpoint.py``:
        the policy and Adam state dicts, every ``EnvState`` tensor, the
        env's and the trainer's generator states (as bytes, which stay on
        the host whatever device the dict is restored onto) and the update
        counter.  One process only, as the JAX package's full-state
        checkpoint (``cli.py:105-111``)."""
        self._one_process("a full-state checkpoint")
        env_state = state.env_state
        return {"policy": state.policy.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "env_state": {f.name: getattr(env_state, f.name)
                              for f in dataclasses.fields(env_state)},
                "env_generator": _bytes(self.env.generator),
                "generator": _bytes(state.generator),
                "update": state.update}

    def load_state_dict(self, saved: dict) -> TrainState:
        """The :class:`TrainState` of :meth:`state_dict`'s ``saved`` on this
        trainer's device; the env's generator takes its saved state."""
        self._one_process("a full-state restore")
        policy, optimizer = self._policy_and_optimizer(self.cfg.seed)
        policy.load_state_dict(saved["policy"])
        # Adam keeps its step counts on the host (it is not capturable);
        # a restore onto the card has moved them there.
        opt = saved["optimizer"]
        opt = {**opt, "state": {i: {k: v.cpu() if k == "step" else v
                                    for k, v in st.items()}
                                for i, st in opt["state"].items()}}
        optimizer.load_state_dict(opt)
        env_state = EnvState(**{k: v.to(self.device)
                                for k, v in saved["env_state"].items()})
        self.env.generator.set_state(_state(saved["env_generator"]))
        generator = torch.Generator(device=self.device)
        generator.set_state(_state(saved["generator"]))
        return TrainState(policy=policy, optimizer=optimizer,
                          env_state=env_state, generator=generator,
                          update=int(saved["update"]))

    def _one_process(self, what: str) -> None:
        if self.world > 1:
            raise RuntimeError(f"{what} is single-process; this trainer is "
                               f"one of {self.world} ranks")

    # ------------------------------------------------------------------

    def _acting_for(self, policy: CNNPolicy, obs) -> _Acting:
        """The acting step of ``policy`` on observations like ``obs``: on
        the card the last rollout's where its ``graphs.key`` holds, else a
        new capture in its place; elsewhere a new one, with trajectory
        buffers of its own."""
        if not graphs.captured_on(self.device):
            return _Acting(policy, obs, self.cfg.horizon)
        key = (graphs.key(policy, obs.scans, obs.goal, obs.speed),
               self.cfg.horizon)
        if self._acting is None or self._acting[0] != key:
            self._acting = None   # a stage-1 trajectory alone is 0.6 GB
            self._acting = (key, _Acting(policy, obs, self.cfg.horizon))
        return self._acting[1]

    def _rollout(self, state: TrainState, noise=None, resets=None):
        """``horizon`` acting steps.  ``noise`` (T, E, 2) and ``resets`` (T
        pairs of reset pose and goal) replace the generators' draws.  On the
        card the trajectory is the trainer's own buffers, rewritten by the
        next rollout at the same shape."""
        cfg, env, policy = self.cfg, self.env, state.policy
        env_state = state.env_state
        obs = env.obs(env_state)
        a, n = obs.scans.shape[:2]
        flat = lambda x: x.reshape(a * n, *x.shape[2:])
        with torch.no_grad():
            acting = self._acting_for(policy, obs)
            acting.t.zero_()
            traj = acting.traj
            for t in range(cfg.horizon):
                with span("act_step"):
                    for k in ("scans", "goal", "speed"):
                        getattr(acting, k).copy_(getattr(obs, k))
                    if noise is None:
                        acting.noise.normal_(generator=state.generator)
                    else:
                        acting.noise.copy_(noise[t])
                    with span("act_policy"):
                        action = acting.step()
                    # the env clips the raw sample to the action bounds
                    env_state, obs, reward, done, info = env.step(
                        env_state, action,
                        *(resets[t] if resets is not None else (None, None)))
                    traj["reward"][t] = reward
                    traj["done"][t] = done
                    for k in ("valid", "reached", "crashed", "ep_return"):
                        traj[k][t] = getattr(info, k)
            # Bootstrap value at the horizon (ppo_stage1.py:94-97).
            last_value = policy(flat(obs.scans), flat(obs.goal),
                                flat(obs.speed))[0][:, 0]
        return env_state, traj, last_value

    def _batch(self, traj, last_value) -> Batch:
        """GAE on (T, E), advantages normalized over every rank's rollout,
        and the arena-major (A, N, T) flatten of ``trainer.py:242-254``:
        sample i = (a, n, t) of this rank's arenas."""
        cfg = self.cfg
        t, a, n = traj["reward"].shape
        e = a * n
        flat_e = lambda x: x.reshape(t, e)
        targets, advs = gae.generate_train_data(
            flat_e(traj["reward"]), flat_e(traj["value"]), last_value,
            flat_e(traj["done"]).float(), cfg.gamma, cfg.lam)
        advs = normalize_shard_advantages(advs)
        flat_m = lambda x: x.movedim(0, 2).reshape(t * e, *x.shape[3:])
        flat_te = lambda x: x.T.reshape(t * e)
        return Batch(scans=flat_m(traj["scans"]), goal=flat_m(traj["goal"]),
                     speed=flat_m(traj["speed"]),
                     action=flat_m(traj["action"]),
                     logprob=flat_m(traj["logprob"])[:, None],
                     target=flat_te(targets)[:, None],
                     adv=flat_te(advs)[:, None],
                     weight=flat_m(traj["valid"]).float())

    def train_step(self, state: TrainState, noise=None, resets=None,
                   perms=None) -> tuple[TrainState, dict]:
        """One update.  ``noise``, ``resets`` (see :meth:`_rollout`) and
        ``perms`` (see ``ppo_update``) let tests inject every
        random draw.
        Returns the new state and the metrics of every rank's rollout as
        Python numbers, with the keys of the JAX trainer's ``_train_step``
        and ``waiting``, the robot-steps spent dead waiting for a group to
        finish (``~valid``; 0 where robots reset alone); in a process group
        ``noise``, ``resets`` and ``perms`` are the rank's own."""
        cfg = self.cfg
        with span("rollout"):
            env_state, traj, last_value = self._rollout(state, noise, resets)
        with span("gae"):
            batch = self._batch(traj, last_value)
        losses = ppo_update(state.policy, state.optimizer, batch, cfg.ppo,
                            perms, state.generator)
        t, a, n = traj["reward"].shape
        # sums over the ranks; every rank has as many rewards, so the mean
        # of their means is the global mean
        sums = dist.all_reduce_sum(torch.stack([
            (traj["done"] & traj["valid"]).sum().float(),
            traj["ep_return"].sum(), traj["reached"].sum().float(),
            traj["crashed"].sum().float(), traj["reward"].mean(),
            (~traj["valid"]).sum().float()]))
        values = torch.cat([torch.stack([losses["policy_loss"],
                                         losses["value_loss"],
                                         losses["entropy"]]), sums]).tolist()
        keys = ("policy_loss", "value_loss", "entropy", "episodes",
                "ep_return_sum", "reached", "crashed", "reward_mean",
                "waiting")
        metrics = dict(zip(keys, values))
        metrics["reward_mean"] /= self.world
        metrics["env_steps"] = t * a * n * self.world
        new_state = dataclasses.replace(state, env_state=env_state,
                                        update=state.update + 1)
        return new_state, metrics

    def train(self, state: TrainState | None = None,
              updates: int | None = None, log_fn=None,
              checkpoint_manager=None, checkpoint_every: int = 20,
              profile_dir: str | None = None) -> TrainState:
        """Host loop: ``updates`` (``cfg.max_updates``) updates, each logged
        through ``log_fn`` with ``update``, ``steps_per_s``,
        ``steps_per_s_ema`` and the update's ``graph_captures`` and
        ``graph_replays`` (``utils/graphs.py``; 0 off the card) added.  With a ``checkpoint_manager``
        (``utils/checkpoint.py``), every ``checkpoint_every``-th update
        (the reference's cadence, ``ppo_stage1.py:122-126``) saves the full
        state, and keeps it as the best when its goal share of ended
        episodes is the highest so far.  With ``profile_dir``, a trace
        (``utils/profiling.trace``, one file a rank) of
        :data:`PROFILE_UPDATES` updates after the first, as the JAX
        ``Trainer.train`` (``trainer.py:278-300``): updates 2 to 4, past
        the first update's warm-up."""
        if state is None:
            state = self.init_state()
        n = updates if updates is not None else self.cfg.max_updates
        first = min(1, n - 1)
        timer = StepTimer()
        with contextlib.ExitStack() as tracing:
            for i in range(n):
                if profile_dir is not None and i == first:
                    tracing.enter_context(trace(profile_dir))
                counts = (graphs.captures, graphs.replays)
                timer.start()
                state, metrics = self.train_step(state)  # ends in a host sync
                metrics["steps_per_s"] = timer.stop(int(metrics["env_steps"]))
                metrics["graph_captures"] = graphs.captures - counts[0]
                metrics["graph_replays"] = graphs.replays - counts[1]
                metrics["update"] = state.update
                metrics["steps_per_s_ema"] = timer.ema
                if i == first + PROFILE_UPDATES - 1:
                    tracing.close()
                if log_fn is not None:
                    log_fn(metrics)
                if (checkpoint_manager is not None
                        and state.update % checkpoint_every == 0):
                    saved = self.state_dict(state)
                    checkpoint_manager.save(state.update, saved)
                    checkpoint_manager.save_best(
                        state.update, saved,
                        metrics["reached"] / max(metrics["episodes"], 1.0))
        return state


def _bytes(generator: torch.Generator) -> bytes:
    return generator.get_state().numpy().tobytes()


def _state(saved: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(saved), dtype=torch.uint8)
