"""Diagonal-Gaussian policy head math (``model/utils.py:90-97``,
``model/net.py:78-79``); counterpart of
``rl_collision_avoidance_tpu/models/distributions.py``."""
from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def log_normal_density(x, mean, logstd):
    """Log N(x; mean, exp(logstd)^2), summed over the last axis, keepdim."""
    var = torch.exp(2.0 * logstd)
    d = -((x - mean) ** 2) / (2.0 * var) - 0.5 * _LOG_2PI - logstd
    return d.sum(dim=-1, keepdim=True)


def sample(mean, logstd, noise=None, generator: torch.Generator | None = None):
    """mean + exp(logstd) * noise; the standard-normal ``noise`` is drawn
    from ``generator`` when not given."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(logstd) * noise


def entropy(logstd):
    """Per-sample entropy of the diagonal Gaussian: sum_i (0.5 + 0.5 log 2pi
    + logstd_i).  State-independent (model/net.py:78-79)."""
    return (0.5 + 0.5 * _LOG_2PI + logstd).sum(dim=-1)
