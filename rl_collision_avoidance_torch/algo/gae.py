"""Generalized Advantage Estimation (``model/ppo.py:111-139``); counterpart
of ``rl_collision_avoidance_tpu/algo/gae.py``, with its reversed
``lax.scan`` as a Python loop over the horizon."""
from __future__ import annotations

import torch


def generate_train_data(rewards, values, last_value, dones, gamma: float,
                        lam: float):
    """rewards/values/dones: (T, E); last_value: (E,).  Backward recursion
    with episode cuts at ``done``.  Returns (targets, advs), both (T, E):
    targets are GAE + value, advantages targets - values."""
    not_done = 1.0 - dones.to(rewards.dtype)
    v_next = torch.cat([values[1:], last_value[None]], dim=0)
    targets = torch.empty_like(rewards)
    gae = torch.zeros_like(last_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * v_next[t] * not_done[t] - values[t]
        gae = delta + gamma * lam * not_done[t] * gae
        targets[t] = gae + values[t]
    return targets, targets - values


def calculate_returns(rewards, dones, last_value, gamma: float = 0.99):
    """Plain discounted returns (``model/ppo.py:111-119``), (T, E)."""
    not_done = 1.0 - dones.to(rewards.dtype)
    returns = torch.empty_like(rewards)
    ret = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        ret = gamma * ret * not_done[t] + rewards[t]
        returns[t] = ret
    return returns
