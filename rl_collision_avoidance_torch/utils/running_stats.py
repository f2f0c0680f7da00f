"""Parallel-algorithm running mean and variance (``model/utils.py:101-128``).

Counterpart of ``rl_collision_avoidance_tpu/utils/running_stats.py``: the
same functional value (``update`` returns a new one), for observation or
reward normalization.  float32 throughout, as the JAX package computes it.
"""
from __future__ import annotations

import dataclasses

import torch

from .device import resolve_device


@dataclasses.dataclass(frozen=True)
class RunningMeanStd:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # a float32 scalar

    @staticmethod
    def create(shape=(), epsilon: float = 1e-4,
               device=None) -> "RunningMeanStd":
        """Mean 0, variance 1, count ``epsilon``, on ``device`` (the CUDA
        card unless told otherwise)."""
        dev = resolve_device(device)
        return RunningMeanStd(
            mean=torch.zeros(shape, dtype=torch.float32, device=dev),
            var=torch.ones(shape, dtype=torch.float32, device=dev),
            count=torch.tensor(epsilon, dtype=torch.float32, device=dev))

    def update(self, x) -> "RunningMeanStd":
        """Chan et al.'s parallel merge of the moments of ``x`` (a tensor or
        array, samples along the leading axis)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.mean.device)
        batch_mean = x.mean(dim=0)
        batch_var = x.var(dim=0, correction=0)
        batch_count = x.shape[0]
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        new_mean = self.mean + delta * batch_count / tot
        m2 = (self.var * self.count + batch_var * batch_count
              + delta ** 2 * self.count * batch_count / tot)
        return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var)
