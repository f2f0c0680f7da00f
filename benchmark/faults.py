"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` catches them (``tests/test_bench_faults.py``,
``calibrate.py``).  Each is a context manager that patches the program
while it is active.

Training: ``unchanged`` (an update returns its state as it came),
``half_batch`` (each minibatch's loss over its first half alone, the mean
over that half), ``altered_grad`` (the trunk backward's actor conv1
weight gradient doubled where it is produced), ``one_leaf`` (an update
leaves one leaf, the actor's fc1 weight, as it came, while Adam's state
moves on), ``wrong_resets`` (the env's reset sampler puts each goal half
as far from its pose).  Eval: ``unchanged`` (an
env step returns its state as it came), ``half_batch`` (the second half of
each step's robots get a zero mean action), ``altered_answer`` (the first
robot's first result of each call turned into a crash).  The exchange
between cards does not apply: every cell runs on one card.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def unchanged_update():
    from rl_collision_avoidance_torch.train import trainer

    def make(train_step):
        def step(self, state, *args, **kwargs):
            # the policy is updated in place: put its parameters back
            saved = {k: v.clone() for k, v in
                     state.policy.state_dict().items()}
            _, metrics = train_step(self, state, *args, **kwargs)
            state.policy.load_state_dict(saved)
            return state, metrics
        return step
    return _patched(trainer.Trainer, "train_step", make)


def half_batch():
    from rl_collision_avoidance_torch.algo import ppo

    def make(ppo_loss):
        def loss(policy, mb, cfg, wsum=None, n_dev=1):
            half = mb.scans.shape[0] // 2
            return ppo_loss(policy, ppo.Batch(*(x[:half] for x in mb)), cfg,
                            None, n_dev)
        return loss
    return _patched(ppo, "ppo_loss", make)


def altered_grad():
    from rl_collision_avoidance_torch.ops import trunk_cuda

    def make(grads):
        def altered(*args, **kwargs):
            act, crt = grads(*args, **kwargs)
            return (2.0 * act[0], *act[1:]), crt
        return altered
    return _patched(trunk_cuda, "twin_trunks_grads", make)


def one_leaf():
    from rl_collision_avoidance_torch.train import trainer

    def make(train_step):
        def step(self, state, *args, **kwargs):
            param = state.policy.get_parameter("act_fc1.weight")
            saved = param.detach().clone()
            out = train_step(self, state, *args, **kwargs)
            with torch.no_grad():
                param.copy_(saved)
            return out
        return step
    return _patched(trainer.Trainer, "train_step", make)


def wrong_resets():
    from rl_collision_avoidance_torch.engine.env import Env

    def make(sample_pose_goal):
        def sample(self, *args, **kwargs):
            pose, goal = sample_pose_goal(self, *args, **kwargs)
            return pose, 0.5 * (pose[..., :2] + goal)
        return sample
    return _patched(Env, "sample_pose_goal", make)


def unchanged_env_step():
    from rl_collision_avoidance_torch.engine.env import Env

    def make(env_step):
        def step(self, state, *args, **kwargs):
            _, _, reward, done, info = env_step(self, state, *args, **kwargs)
            return state, self.obs(state), reward, done, info
        return step
    return _patched(Env, "step", make)


def half_robots():
    from rl_collision_avoidance_torch.models.policy import CNNPolicy

    def make(forward):
        def half(self, scans, goal, speed):
            value, mean, logstd = forward(self, scans, goal, speed)
            mean = mean.clone()
            mean[mean.shape[0] // 2:] = 0.0
            return value, mean, logstd
        return half
    return _patched(CNNPolicy, "forward", make)


def altered_answer():
    from rl_collision_avoidance_torch.eval import circle

    def make(run_episodes):
        def run(*args, **kwargs):
            done, first, start = run_episodes(*args, **kwargs)
            first = first.clone()
            first[0, 0] = 2
            return done, first, start
        return run
    return _patched(circle, "run_episodes", make)


FAULTS = {"train": {"unchanged": unchanged_update, "half_batch": half_batch,
                    "altered_grad": altered_grad, "one_leaf": one_leaf,
                    "wrong_resets": wrong_resets},
          "eval": {"unchanged": unchanged_env_step, "half_batch": half_robots,
                   "altered_answer": altered_answer}}
