"""Clipped PPO (``model/ppo.py:143-259``); counterpart of
``rl_collision_avoidance_tpu/algo/ppo.py``.

Advantages are normalized over the whole rollout, then each epoch takes the
rollout in a fresh random order, cut into minibatches, and steps Adam on the
loss ``policy + 20 * value - coeff_entropy * entropy`` with ratio clipping.
Transitions that must not train (stage 2's dead robots) carry weight 0
instead of being deleted.  On CUDA the policy's trunks run through the
hand-written forward and backward kernels (``ops/trunk_cuda.py``).
Under a process group (``parallel/dist.py``) each rank updates on its own
shard of the rollout and the gradients are summed over the ranks.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..models import distributions
from ..parallel.dist import (all_gather_flat, all_reduce_sum, is_initialized,
                             rank, world_size)


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


def normalize_shard_advantages(advs: torch.Tensor) -> torch.Tensor:
    """This rank's ``advs`` normalized with the mean and std of every
    rank's, as the JAX step's: gathered (393 KB at stage 1's 32 arenas),
    normalized as one vector by :func:`normalize_advantages`, and this
    rank's slice kept; ``normalize_advantages(advs)`` without a group."""
    full = all_gather_flat(advs).view(world_size(), *advs.shape)
    return normalize_advantages(full)[rank()]


def ppo_loss(policy, mb: Batch, cfg: PPOConfig, wsum=None, n_dev: int = 1):
    """Returns (loss, (policy_loss, value_loss, entropy)).

    ``wsum``: what the weighted sums are divided by, by default this
    minibatch's weight sum (at least 1).  ``n_dev``: the ranks a global
    minibatch is split over; the entropy term, state-independent and the
    same on every rank, is then weighted 1 / n_dev (the entropy returned
    too), so that the ranks' gradients sum to the whole minibatch's
    (``rl_collision_avoidance_tpu/algo/ppo.py:143-160``)."""
    value, mean, logstd = policy(mb.scans, mb.goal, mb.speed)
    new_logprob = distributions.log_normal_density(mb.action, mean, logstd)
    ratio = torch.exp(new_logprob - mb.logprob)          # (B, 1)
    surr1 = ratio * mb.adv
    surr2 = torch.clamp(ratio, 1.0 - cfg.clip_value,
                        1.0 + cfg.clip_value) * mb.adv
    w = mb.weight[:, None]
    if wsum is None:
        wsum = torch.clamp(w.sum(), min=1.0)
    policy_loss = -(torch.minimum(surr1, surr2) * w).sum() / wsum
    value_loss = ((value - mb.target) ** 2 * w).sum() / wsum
    ent = distributions.entropy(logstd)                  # same for all samples
    if n_dev > 1:
        ent = ent / n_dev
    loss = (policy_loss + cfg.value_coeff * value_loss
            - cfg.coeff_entropy * ent)
    return loss, (policy_loss, value_loss, ent)


def all_reduce_grads(params) -> None:
    """Sum the ``params``' gradients over the ranks, in place: flattened
    into one buffer, one all-reduce (one collective a minibatch, not one a
    tensor), and copied back."""
    grads = [p.grad for p in params]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def ppo_update(policy, optimizer, batch: Batch, cfg: PPOConfig,
               perms: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> dict:
    """``cfg.epochs`` passes of shuffled minibatches of PPO SGD, in place on
    ``policy`` and ``optimizer`` (``torch.optim.Adam``), over the W ranks of
    the default process group (one rank without one); the counterpart of
    ``rl_collision_avoidance_tpu/algo/ppo.py::ppo_update`` and, with W > 1,
    of its ``ppo_update_sharded``.

    ``batch`` is this rank's shard of the rollout (its arenas' samples; the
    whole rollout with one rank) and ``cfg.batch_size`` the global
    minibatch, ``batch_size / W`` samples a rank.  Each rank orders its own
    samples: ``perms`` (epochs, used), used = the whole local minibatches
    that fit, or drawn from ``generator``, so every minibatch takes an
    equal stratum of each shard and the batch is never regathered.  The
    weight sums of all minibatches are all-reduced in one collective before
    the first epoch; each minibatch's loss is divided by its global weight
    sum, its entropy term weighted 1 / W (:func:`ppo_loss`), and its
    gradients summed over the ranks (:func:`all_reduce_grads`) before Adam,
    which then steps identically on every rank.  The per-minibatch losses
    are all-reduced once at the end.

    Returns the means over all minibatches of policy_loss, value_loss and
    entropy, as 0-d tensors (the reference's ``ppo.log`` stream), and under
    ``minibatches`` the same three for each minibatch, (epochs * n_mb, 3);
    global over the ranks.  With one rank every collective is the identity
    or a copy, the entropy is not divided, and the weights are 0 or 1, so
    their sums are exact in any order: the one-process arithmetic."""
    w = world_size()
    m = batch.scans.shape[0]
    if cfg.batch_size % w:
        raise ValueError(f"batch_size {cfg.batch_size} does not divide over "
                         f"{w} ranks")
    bs = cfg.batch_size // w
    n_mb = m // bs
    if n_mb == 0:
        raise ValueError(f"batch_size {cfg.batch_size} is larger than the "
                         f"rollout of {m * w} samples")
    used = n_mb * bs
    _warn_dropped(m * w, used * w, cfg.batch_size)
    if perms is None:
        device = batch.scans.device
        perms = torch.stack([
            torch.randperm(m, generator=generator, device=device)[:used]
            for _ in range(cfg.epochs)])
    idxs = perms.reshape(cfg.epochs, n_mb, bs)
    wsums = torch.clamp(all_reduce_sum(batch.weight[idxs].sum(-1)), min=1.0)
    params = list(policy.parameters())
    aux = []
    for epoch in range(cfg.epochs):
        for idx, wsum in zip(idxs[epoch], wsums[epoch]):
            with record_function("ppo_forward"):
                mb = Batch(*(x[idx] for x in batch))
                loss, parts = ppo_loss(policy, mb, cfg, wsum, w)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if is_initialized():
                with record_function("grad_all_reduce"):
                    all_reduce_grads(params)
            with record_function("adam"):
                optimizer.step()
                if cfg.logstd_min is not None:
                    _clamp_logstd(policy, cfg.logstd_min)
                aux.append(torch.stack([p.detach() for p in parts]))
    aux = all_reduce_sum(torch.stack(aux))
    metrics = aux.mean(dim=0)
    return {"policy_loss": metrics[0], "value_loss": metrics[1],
            "entropy": metrics[2], "minibatches": aux}
