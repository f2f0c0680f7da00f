"""The twin-trunk Gaussian actor-critic (``model/net.py:16-80``) and the
reference's small MLP alternative (``:83-133``) as ``nn.Module``s.

Counterpart of ``rl_collision_avoidance_tpu/models/policy.py::CNNPolicy``
in the reference PyTorch layout: Conv1d over (batch, frames, beams), a
channel-major flatten, and the reference parameter names, so
``utils/params.py`` maps the JAX package's trained weights straight in.
The two feature trunks run through ``ops/trunk_cuda.py::twin_trunks``: on
CUDA the hand-written forward kernel, and where autograd needs the weights'
gradients the ``TwinTrunks`` Function, which pairs it with the backward
kernel (the JAX package's ``apply_impl="pallas"``); on the CPU their plain
versions.  The dense tail, fc2 and the heads, and ``logstd`` stay ordinary
PyTorch and autograd, as they stay outside the kernels in the JAX package
(``cnn_pallas_apply``).

``dtype=torch.bfloat16`` is the JAX package's mixed precision, as
``cnn_pallas_apply(dtype=bfloat16)`` computes it: the trunks run the
kernels' bf16 mode (bf16 products, float32 sums, bf16 features), and the
dense tail casts its weights and inputs to bf16 inside ``forward`` (an
explicit cast, not autocast, so the CPU and the card compute the same
function); ``value`` and ``mean`` come back as float32 and ``logstd``
stays float32.  Parameters are float32 in either mode.

:class:`MLPPolicy` is the counterpart of the JAX package's ``MLPPolicy``:
plain PyTorch (the JAX module has no kernel either), in float32 or, with
the same explicit casts, bf16.  :func:`load_policy` reads a JAX npz or a
reference ``.pth`` checkpoint into a ``CNNPolicy``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.trunk_cuda import twin_trunks
from ..utils.device import resolve_device
from ..utils.params import jax_params_to_torch, load_jax_npz, load_pth


def _conv_len(n: int, k: int) -> int:
    return (n + 2 - k) // 2 + 1       # stride 2, padding 1


#: The trunk kernels' mode for each compute dtype of the policy.
PRECISION = {torch.float32: "float32", torch.bfloat16: "bf16"}


def _check_dtype(net: str, dtype: torch.dtype) -> None:
    if dtype not in PRECISION:
        raise ValueError(f"{net} computes in float32 or bfloat16, not {dtype}")


def dense(x, layer: nn.Linear, dtype: torch.dtype):
    """``layer`` on ``x`` in ``dtype``: in bf16 as the JAX package's bf16
    dense layers, x @ W + b with both results rounded to bf16."""
    if dtype == torch.float32:
        return layer(x)
    return F.linear(x, layer.weight.to(dtype)) + layer.bias.to(dtype)


class CNNPolicy(nn.Module):
    """forward(scans (B, F, NB), goal (B, 2), speed (B, 2))
    -> (value (B, 1), mean (B, 2), logstd (2,)), float32; ``dtype`` is the
    compute dtype (float32 or bfloat16)."""

    def __init__(self, frames: int = 3, beams: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_dtype("CNNPolicy", dtype)
        self.dtype = dtype
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

    def dense(self, x, layer: nn.Linear):
        """``layer`` on ``x`` in the policy's dtype: in bf16 as
        ``cnn_pallas_apply``'s ``dense`` (see :func:`dense`)."""
        return dense(x, layer, self.dtype)

    def heads(self, feats, goal, speed):
        """The dense tail on the (2, B, 256) trunk features, in the
        policy's dtype; in bf16 value and mean come back as float32."""
        bf16, dense = self.dtype != torch.float32, self.dense
        cast = (lambda t: t.to(self.dtype)) if bf16 else (lambda t: t)
        gs = torch.cat([cast(goal), cast(speed)], dim=-1)
        a = F.relu(dense(torch.cat([cast(feats[0]), gs], dim=-1),
                         self.act_fc2))
        mean = torch.cat([torch.sigmoid(dense(a, self.actor1)),
                          torch.tanh(dense(a, self.actor2))], dim=-1)
        c = F.relu(dense(torch.cat([cast(feats[1]), gs], dim=-1),
                         self.crt_fc2))
        value = dense(c, self.critic)
        if bf16:
            value, mean = value.float(), mean.float()
        return value, mean, self.logstd

    def forward(self, scans, goal, speed):
        feats = twin_trunks(scans, self.trunk_weights("act"),
                            self.trunk_weights("crt"), PRECISION[self.dtype])
        return self.heads(feats, goal, speed)


class MLPPolicy(nn.Module):
    """forward(obs (B, obs_dim)) -> (value (B, 1), mean (B, action_dim),
    logstd (action_dim,)), float32: two tanh layers of 64 and 128 for the
    actor and for the critic, a linear mean and value.  PyTorch's default
    init, with the ``mu`` weight scaled by 0.1; ``value_fc3`` stays
    unscaled, as in the reference, whose out-of-place ``mul`` leaves it so
    (``model/net.py:98``).  ``dtype`` is the compute dtype (float32 or
    bfloat16); parameters are float32."""

    def __init__(self, obs_dim: int, action_dim: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_dtype("MLPPolicy", dtype)
        self.dtype = dtype
        self.logstd = nn.Parameter(torch.zeros(action_dim))
        self.act_fc1 = nn.Linear(obs_dim, 64)
        self.act_fc2 = nn.Linear(64, 128)
        self.mu = nn.Linear(128, action_dim)
        with torch.no_grad():
            self.mu.weight.mul_(0.1)
        self.value_fc1 = nn.Linear(obs_dim, 64)
        self.value_fc2 = nn.Linear(64, 128)
        self.value_fc3 = nn.Linear(128, 1)

    def forward(self, obs):
        x = obs.to(self.dtype)
        layer = lambda h, fc: dense(h, fc, self.dtype)
        a = torch.tanh(layer(torch.tanh(layer(x, self.act_fc1)),
                             self.act_fc2))
        mean = layer(a, self.mu)
        v = torch.tanh(layer(torch.tanh(layer(x, self.value_fc1)),
                             self.value_fc2))
        value = layer(v, self.value_fc3)
        return value.float(), mean.float(), self.logstd


def load_policy(path, device=None, frames: int = 3, beams: int = 512,
                dtype: torch.dtype = torch.float32) -> CNNPolicy:
    """A ``CNNPolicy`` computing in ``dtype`` on ``device`` (the CUDA card
    unless told otherwise) with the weights of ``path``: a JAX
    ``save_params_npz`` file (``.npz``), or a reference checkpoint, the
    ``torch.save``d ``CNNPolicy.state_dict()`` (any other name, e.g.
    ``policy/stage2.pth``), whose keys and shapes are checked first."""
    policy = CNNPolicy(frames, beams, dtype)
    if str(path).endswith(".npz"):
        state = jax_params_to_torch(load_jax_npz(path))
    else:
        state = load_pth(path)
        want = {k: tuple(v.shape) for k, v in policy.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in state.items()}
        wrong = sorted(k for k in want.keys() & got.keys()
                       if want[k] != got[k])
        if want.keys() != got.keys() or wrong:
            raise ValueError(
                f"{path}: not the state dict of a CNNPolicy({frames}, "
                f"{beams}): missing {sorted(want.keys() - got.keys())}, "
                f"unexpected {sorted(got.keys() - want.keys())}, shapes "
                f"{[(k, got[k], want[k]) for k in wrong]} (found, wanted)")
    policy.load_state_dict(state)
    return policy.to(resolve_device(device)).eval()
