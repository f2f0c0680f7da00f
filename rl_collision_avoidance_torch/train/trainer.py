"""The training loop: rollout, bootstrap, GAE and PPO, one update at a time.

Counterpart of ``rl_collision_avoidance_tpu/train/trainer.py`` for stage 1
on one device.  One :meth:`Trainer.train_step` is one reference "update"
(``ppo_stage1.py:39-130``): ``horizon`` acting steps of every robot of every
arena, the bootstrap value at the horizon, GAE over (T, E), advantage
normalization, an arena-major flatten and the PPO epochs.  On the CUDA card
the policy runs through the trunk forward kernel in the rollout and through
the forward and backward kernels in the update; the env step runs the lidar
kernel.  Phases are marked with ``torch.profiler.record_function`` so that
``bench --train --profile`` can split the device time.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..algo import gae
from ..algo.ppo import Batch, PPOConfig, normalize_advantages, ppo_update
from ..engine.env import Env, EnvState
from ..models import CNNPolicy, distributions
from ..utils.device import resolve_device
from ..utils.profiling import StepTimer
from ..worlds import get_world


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters; defaults = stage-1 reference (ppo_stage1.py:22-35)."""
    world: str = "stage1"
    n_arenas: int = 1          # arenas (replicas of the world); reference = 1
    horizon: int = 128
    gamma: float = 0.99
    lam: float = 0.95
    ppo: PPOConfig = PPOConfig(batch_size=1024, epochs=2, clip_value=0.1,
                               coeff_entropy=5e-4, learning_rate=5e-5)
    seed: int = 0
    max_updates: int = 2000

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


@dataclasses.dataclass
class TrainState:
    """What one update reads and writes.  ``policy`` and ``optimizer`` are
    updated in place by :meth:`Trainer.train_step`."""
    policy: CNNPolicy
    optimizer: torch.optim.Adam
    env_state: EnvState      # leading axis = arenas
    generator: torch.Generator  # action noise and minibatch order
    update: int


class Trainer:
    """Owns the env and runs updates on one device (the CUDA card unless
    ``device`` says otherwise)."""

    def __init__(self, cfg: TrainConfig, device=None):
        self.cfg = cfg
        self.spec = get_world(cfg.world)
        self.device = resolve_device(device)
        self.env = Env(self.spec, device=self.device, seed=cfg.seed)

    def init_state(self, seed: int | None = None) -> TrainState:
        """Fresh arenas, a policy with PyTorch's default init from a
        generator seeded by ``seed`` (``cfg.seed``), and Adam with optax's
        ``adam`` defaults (``trainer.py:142``)."""
        seed = self.cfg.seed if seed is None else seed
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            policy = CNNPolicy(self.spec.laser_frames, self.spec.n_beams)
        policy = policy.to(self.device)
        optimizer = torch.optim.Adam(policy.parameters(),
                                     lr=self.cfg.ppo.learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
        self.env.generator.manual_seed(seed)
        env_state, _ = self.env.reset(self.cfg.n_arenas)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed + 1)
        return TrainState(policy=policy, optimizer=optimizer,
                          env_state=env_state, generator=generator, update=0)

    # ------------------------------------------------------------------

    def _rollout(self, state: TrainState, noise=None, resets=None):
        """``horizon`` acting steps.  ``noise`` (T, E, 2) and ``resets`` (T
        pairs of reset pose and goal) replace the generators' draws."""
        cfg, env, policy = self.cfg, self.env, state.policy
        env_state = state.env_state
        obs = env.obs(env_state)
        a, n = obs.scans.shape[:2]
        e = a * n
        flat = lambda x: x.reshape(e, *x.shape[2:])
        buf = lambda *shape, dtype=torch.float32: torch.empty(
            (cfg.horizon, a, n, *shape), dtype=dtype, device=self.device)
        traj = {"scans": buf(*obs.scans.shape[2:]), "goal": buf(2),
                "speed": buf(2), "action": buf(2), "logprob": buf(),
                "value": buf(), "reward": buf(),
                **{k: buf(dtype=torch.bool) for k in
                   ("done", "valid", "reached", "crashed")},
                "ep_return": buf()}
        with torch.no_grad():
            for t in range(cfg.horizon):
                value, mean, logstd = policy(flat(obs.scans), flat(obs.goal),
                                             flat(obs.speed))
                raw = distributions.sample(
                    mean, logstd, None if noise is None else noise[t],
                    state.generator)
                logprob = distributions.log_normal_density(raw, mean, logstd)
                for k in ("scans", "goal", "speed"):
                    traj[k][t] = getattr(obs, k)
                traj["action"][t] = raw.reshape(a, n, 2)
                traj["logprob"][t] = logprob.reshape(a, n)
                traj["value"][t] = value.reshape(a, n)
                # the env clips the raw sample to the action bounds
                env_state, obs, reward, done, info = env.step(
                    env_state, raw.reshape(a, n, 2),
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
        """GAE on (T, E), normalized advantages, and the arena-major (A, N,
        T) flatten of ``trainer.py:242-254``: sample i = (a, n, t)."""
        cfg = self.cfg
        t, a, n = traj["reward"].shape
        e = a * n
        flat_e = lambda x: x.reshape(t, e)
        targets, advs = gae.generate_train_data(
            flat_e(traj["reward"]), flat_e(traj["value"]), last_value,
            flat_e(traj["done"]).float(), cfg.gamma, cfg.lam)
        advs = normalize_advantages(advs)
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
        ``perms`` (see ``ppo_update``) let tests inject every random draw.
        Returns the new state and the metrics as Python numbers, with the
        keys of the JAX trainer's ``_train_step``."""
        cfg = self.cfg
        with record_function("rollout"):
            env_state, traj, last_value = self._rollout(state, noise, resets)
        with record_function("gae"):
            batch = self._batch(traj, last_value)
        losses = ppo_update(state.policy, state.optimizer, batch, cfg.ppo,
                            perms, state.generator)
        t, a, n = traj["reward"].shape
        sums = torch.stack([
            losses["policy_loss"], losses["value_loss"], losses["entropy"],
            (traj["done"] & traj["valid"]).sum().float(),
            traj["ep_return"].sum(), traj["reached"].sum().float(),
            traj["crashed"].sum().float(), traj["reward"].mean()]).tolist()
        keys = ("policy_loss", "value_loss", "entropy", "episodes",
                "ep_return_sum", "reached", "crashed", "reward_mean")
        metrics = dict(zip(keys, sums))
        metrics["env_steps"] = t * a * n
        new_state = dataclasses.replace(state, env_state=env_state,
                                        update=state.update + 1)
        return new_state, metrics

    def train(self, state: TrainState | None = None,
              updates: int | None = None, log_fn=None) -> TrainState:
        """Host loop: ``updates`` (``cfg.max_updates``) updates, each logged
        through ``log_fn`` with ``update``, ``steps_per_s`` and
        ``steps_per_s_ema`` added."""
        if state is None:
            state = self.init_state()
        n = updates if updates is not None else self.cfg.max_updates
        timer = StepTimer()
        for _ in range(n):
            timer.start()
            state, metrics = self.train_step(state)   # ends in a host sync
            metrics["steps_per_s"] = timer.stop(int(metrics["env_steps"]))
            metrics["update"] = state.update
            metrics["steps_per_s_ema"] = timer.ema
            if log_fn is not None:
                log_fn(metrics)
        return state
