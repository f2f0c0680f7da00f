"""The twin-trunk Gaussian actor-critic of ``model/net.py``, plain.

Parameters are a dict of float32 tensors under the reference network's
names (``act_fea_cv1.weight`` ... ``critic.bias``, ``logstd``), in its
PyTorch layout: Conv1d (out, in, k), Linear (out, in), a channel-major
flatten.  Each trunk is conv 32x5 stride 2, conv 32x3 stride 2, fc 256,
all with ReLU; the actor's tail is fc 128 on the features, goal and speed,
then a sigmoid linear speed and a tanh angular speed; the critic's is fc
128 and a linear value; ``logstd`` is state-independent.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from .world import fc1_inputs

LOG_2PI = math.log(2.0 * math.pi)


def shapes(model: dict) -> dict:
    """Every parameter's shape, in the reference's order."""
    f, c1, c2 = model["frames"], model["conv1"], model["conv2"]
    h, t = model["fc1"], model["fc2"]
    out = {"logstd": (2,)}
    for net in ("act", "crt"):
        out.update({
            f"{net}_fea_cv1.weight": (c1["channels"], f, c1["kernel"]),
            f"{net}_fea_cv1.bias": (c1["channels"],),
            f"{net}_fea_cv2.weight": (c2["channels"], c1["channels"],
                                      c2["kernel"]),
            f"{net}_fea_cv2.bias": (c2["channels"],),
            f"{net}_fc1.weight": (h, fc1_inputs(model)),
            f"{net}_fc1.bias": (h,),
            f"{net}_fc2.weight": (t, h + 4),
            f"{net}_fc2.bias": (t,)})
        heads = ("actor1", "actor2") if net == "act" else ("critic",)
        for name in heads:
            out.update({f"{name}.weight": (1, t), f"{name}.bias": (1,)})
    return out


def fan_in(shape) -> int:
    return math.prod(shape[1:]) if len(shape) > 1 else 0


def trunk(p: dict, net: str, model: dict, scans):
    c1, c2 = model["conv1"], model["conv2"]
    x = F.relu(F.conv1d(scans, p[f"{net}_fea_cv1.weight"],
                        p[f"{net}_fea_cv1.bias"], stride=c1["stride"],
                        padding=c1["padding"]))
    x = F.relu(F.conv1d(x, p[f"{net}_fea_cv2.weight"],
                        p[f"{net}_fea_cv2.bias"], stride=c2["stride"],
                        padding=c2["padding"]))
    return F.relu(F.linear(x.flatten(1), p[f"{net}_fc1.weight"],
                           p[f"{net}_fc1.bias"]))


def forward(p: dict, model: dict, scans, goal, speed, actor_only=False):
    """(value (B, 1) or None, mean (B, 2), logstd (2,))."""
    lin = lambda x, name: F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])
    a = F.relu(lin(torch.cat([trunk(p, "act", model, scans), goal, speed],
                             dim=-1), "act_fc2"))
    mean = torch.cat([torch.sigmoid(lin(a, "actor1")),
                      torch.tanh(lin(a, "actor2"))], dim=-1)
    if actor_only:
        return None, mean, p["logstd"]
    c = F.relu(lin(torch.cat([trunk(p, "crt", model, scans), goal, speed],
                             dim=-1), "crt_fc2"))
    return lin(c, "critic"), mean, p["logstd"]


def log_density(x, mean, logstd):
    d = -((x - mean) ** 2) / (2.0 * torch.exp(2.0 * logstd)) \
        - 0.5 * LOG_2PI - logstd
    return d.sum(dim=-1, keepdim=True)


def entropy(logstd):
    return (0.5 + 0.5 * LOG_2PI + logstd).sum(dim=-1)
