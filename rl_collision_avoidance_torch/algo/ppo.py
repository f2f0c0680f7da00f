"""Clipped PPO (``model/ppo.py:143-259``); counterpart of
``rl_collision_avoidance_tpu/algo/ppo.py``.

Advantages are normalized over the whole rollout, then each epoch takes the
rollout in a fresh random order, cut into minibatches, and steps Adam on the
loss ``policy + 20 * value - coeff_entropy * entropy`` with ratio clipping.
Transitions that must not train (stage 2's dead robots) carry weight 0
instead of being deleted.  On CUDA the policy's trunks run through the
hand-written forward and backward kernels (``ops/trunk_cuda.py``).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..models import distributions


def _warn_dropped(m: int, used: int, batch_size: int):
    """Every epoch uses the same number of whole minibatches, so a rollout
    that is not a multiple of the batch size loses its remainder (the
    reference's stage 1, ``drop_last=False``, would keep it): warn."""
    if used < m:
        warnings.warn(
            f"PPO rollout of {m} samples is not divisible by batch_size "
            f"{batch_size}: {m - used} samples per epoch are dropped "
            "(the reference's stage-1 drop_last=False would keep them)",
            stacklevel=3)


class PPOConfig(NamedTuple):
    batch_size: int = 1024
    epochs: int = 2
    clip_value: float = 0.1
    coeff_entropy: float = 5e-4
    value_coeff: float = 20.0
    learning_rate: float = 5e-5
    # Floor for the state-independent logstd, projected after every
    # optimizer step; None = no floor (the reference has none).
    logstd_min: float | None = None


def _clamp_logstd(policy, lo: float):
    """Project the policy's logstd parameter onto [lo, inf)."""
    with torch.no_grad():
        policy.logstd.clamp_(min=lo)


class Batch(NamedTuple):
    """Flattened rollout, leading axis M = horizon * num_env."""
    scans: torch.Tensor    # (M, F, B)
    goal: torch.Tensor     # (M, 2)
    speed: torch.Tensor    # (M, 2)
    action: torch.Tensor   # (M, 2) raw (unclipped) samples, as the reference
    logprob: torch.Tensor  # (M, 1) behavior log-prob
    target: torch.Tensor   # (M, 1)
    adv: torch.Tensor      # (M, 1) already normalized
    weight: torch.Tensor   # (M,) 1.0 = train on it, 0.0 = masked out


def normalize_advantages(advs: torch.Tensor) -> torch.Tensor:
    """(advs - mean) / std over the full rollout, with the population std
    (``model/ppo.py:148``)."""
    return (advs - advs.mean()) / advs.std(correction=0)


def ppo_loss(policy, mb: Batch, cfg: PPOConfig):
    """Returns (loss, (policy_loss, value_loss, entropy))."""
    value, mean, logstd = policy(mb.scans, mb.goal, mb.speed)
    new_logprob = distributions.log_normal_density(mb.action, mean, logstd)
    ratio = torch.exp(new_logprob - mb.logprob)          # (B, 1)
    surr1 = ratio * mb.adv
    surr2 = torch.clamp(ratio, 1.0 - cfg.clip_value,
                        1.0 + cfg.clip_value) * mb.adv
    w = mb.weight[:, None]
    wsum = torch.clamp(w.sum(), min=1.0)
    policy_loss = -(torch.minimum(surr1, surr2) * w).sum() / wsum
    value_loss = ((value - mb.target) ** 2 * w).sum() / wsum
    ent = distributions.entropy(logstd)                  # same for all samples
    loss = (policy_loss + cfg.value_coeff * value_loss
            - cfg.coeff_entropy * ent)
    return loss, (policy_loss, value_loss, ent)


def ppo_update(policy, optimizer, batch: Batch, cfg: PPOConfig,
               perms: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> dict:
    """``cfg.epochs`` passes of shuffled minibatches of PPO SGD, in place on
    ``policy`` and ``optimizer`` (``torch.optim.Adam``).

    ``perms`` (epochs, used): each epoch's sample order, used = the whole
    minibatches that fit; drawn from ``generator`` when not given.  Returns
    the means over all minibatches of policy_loss, value_loss and entropy,
    as 0-d tensors (the reference's ``ppo.log`` stream), and under
    ``minibatches`` the same three for each minibatch, (epochs * n_mb, 3)."""
    m = batch.scans.shape[0]
    n_mb = m // cfg.batch_size
    if n_mb == 0:
        raise ValueError(f"batch_size {cfg.batch_size} is larger than the "
                         f"rollout of {m} samples")
    used = n_mb * cfg.batch_size
    _warn_dropped(m, used, cfg.batch_size)
    if perms is None:
        device = batch.scans.device
        perms = torch.stack([
            torch.randperm(m, generator=generator, device=device)[:used]
            for _ in range(cfg.epochs)])
    aux = []
    for epoch in range(cfg.epochs):
        for idx in perms[epoch].reshape(n_mb, cfg.batch_size):
            with record_function("ppo_forward"):
                mb = Batch(*(x[idx] for x in batch))
                loss, parts = ppo_loss(policy, mb, cfg)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            with record_function("adam"):
                optimizer.step()
                if cfg.logstd_min is not None:
                    _clamp_logstd(policy, cfg.logstd_min)
                aux.append(torch.stack([p.detach() for p in parts]))
    aux = torch.stack(aux)
    metrics = aux.mean(dim=0)
    return {"policy_loss": metrics[0], "value_loss": metrics[1],
            "entropy": metrics[2], "minibatches": aux}
