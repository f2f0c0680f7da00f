"""The twin-trunk Gaussian actor-critic (``model/net.py:16-80``) as an
``nn.Module``.

Counterpart of ``rl_collision_avoidance_tpu/models/policy.py::CNNPolicy``
in the reference PyTorch layout: Conv1d over (batch, frames, beams), a
channel-major flatten, and the reference parameter names, so
``utils/params.py`` maps the JAX package's trained weights straight in.
The two feature trunks run through ``ops/trunk_cuda.py::twin_trunks`` (the
hand-written kernel on CUDA, its plain version on the CPU); the dense tail,
fc2 and the heads, stays ordinary PyTorch, as it stays outside the kernel
in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.trunk_cuda import twin_trunks
from ..utils.device import resolve_device
from ..utils.params import jax_params_to_torch, load_jax_npz


def _conv_len(n: int, k: int) -> int:
    return (n + 2 - k) // 2 + 1       # stride 2, padding 1


class CNNPolicy(nn.Module):
    """forward(scans (B, F, NB), goal (B, 2), speed (B, 2))
    -> (value (B, 1), mean (B, 2), logstd (2,))."""

    def __init__(self, frames: int = 3, beams: int = 512):
        super().__init__()
        flat = 32 * _conv_len(_conv_len(beams, 5), 3)
        self.logstd = nn.Parameter(torch.zeros(2))
        self.act_fea_cv1 = nn.Conv1d(frames, 32, 5, stride=2, padding=1)
        self.act_fea_cv2 = nn.Conv1d(32, 32, 3, stride=2, padding=1)
        self.act_fc1 = nn.Linear(flat, 256)
        self.act_fc2 = nn.Linear(256 + 2 + 2, 128)
        self.actor1 = nn.Linear(128, 1)
        self.actor2 = nn.Linear(128, 1)
        self.crt_fea_cv1 = nn.Conv1d(frames, 32, 5, stride=2, padding=1)
        self.crt_fea_cv2 = nn.Conv1d(32, 32, 3, stride=2, padding=1)
        self.crt_fc1 = nn.Linear(flat, 256)
        self.crt_fc2 = nn.Linear(256 + 2 + 2, 128)
        self.critic = nn.Linear(128, 1)

    def trunk_weights(self, prefix: str) -> tuple:
        """One trunk's weights in ``ops/trunk_cuda.WEIGHT_NAMES`` order."""
        cv1, cv2, fc1 = (getattr(self, f"{prefix}_{n}")
                         for n in ("fea_cv1", "fea_cv2", "fc1"))
        return (cv1.weight, cv1.bias, cv2.weight, cv2.bias, fc1.weight,
                fc1.bias)

    def heads(self, feats, goal, speed):
        """The dense tail on the (2, B, 256) trunk features."""
        gs = torch.cat([goal, speed], dim=-1)
        a = F.relu(self.act_fc2(torch.cat([feats[0], gs], dim=-1)))
        mean = torch.cat([torch.sigmoid(self.actor1(a)),
                          torch.tanh(self.actor2(a))], dim=-1)
        c = F.relu(self.crt_fc2(torch.cat([feats[1], gs], dim=-1)))
        return self.critic(c), mean, self.logstd

    def forward(self, scans, goal, speed):
        feats = twin_trunks(scans, self.trunk_weights("act"),
                            self.trunk_weights("crt"))
        return self.heads(feats, goal, speed)


def load_policy(path, device=None, frames: int = 3,
                beams: int = 512) -> CNNPolicy:
    """A ``CNNPolicy`` on ``device`` (the CUDA card unless told otherwise)
    with the weights of a JAX ``save_params_npz`` file."""
    policy = CNNPolicy(frames, beams)
    policy.load_state_dict(jax_params_to_torch(load_jax_npz(path)))
    return policy.to(resolve_device(device)).eval()
