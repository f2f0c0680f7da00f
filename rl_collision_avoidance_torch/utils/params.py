"""Carry trained weights between the JAX package and the port.

``load_jax_npz`` reads a ``save_params_npz`` file of the JAX package (one
array per flax leaf, keyed by its key path, e.g.
``['params']['act_trunk']['Conv_0']['kernel']``) with numpy alone.
``jax_params_to_torch`` maps that tree onto the state dict of the port's
:class:`~..models.policy.CNNPolicy`, whose names and layouts are the
reference PyTorch network's:

* flax Conv kernel (k, in, out)  ->  torch Conv1d weight (out, in, k);
* flax Dense kernel (in, out)    ->  torch Linear weight (out, in);
* the post-conv flatten differs: flax flattens (L, C) length-major, torch
  flattens (C, L) channel-major, so fc1's input axis is permuted.

``torch_to_jax_params`` is the inverse mapping and ``save_params_npz``
writes the JAX file format, so a policy trained by the port loads into the
JAX package (``utils/checkpoint.py::load_params_npz``) and back.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_KEY = re.compile(r"\['([^']*)'\]")
_CHANNELS = 32  # conv2 output channels


def load_jax_npz(path) -> dict:
    """Nested dict of numpy arrays from a JAX ``save_params_npz`` file."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = _KEY.findall(key)
            if not parts or "".join(f"['{p}']" for p in parts) != key:
                raise ValueError(f"{path}: unexpected key {key!r}")
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return tree


def _flat_perm(length: int) -> np.ndarray:
    """p with torch_flat[p] == flax_flat: flax position (l, c) holds torch
    position c * length + l."""
    return np.arange(_CHANNELS * length).reshape(_CHANNELS, length).T.reshape(-1)


def jax_params_to_torch(params: dict) -> dict:
    """JAX ``CNNPolicy`` params tree (with or without the top ``params``
    level) -> the port's ``CNNPolicy`` state dict of float32 tensors."""
    p = params.get("params", params)
    conv = lambda w: np.transpose(np.asarray(w), (2, 1, 0))
    dense = lambda w: np.transpose(np.asarray(w))
    out = {"logstd": np.asarray(p["logstd"])}
    for pre in ("act", "crt"):
        t = p[f"{pre}_trunk"]
        fc1 = dense(t["Dense_0"]["kernel"])                 # (256, L * C)
        inv = np.argsort(_flat_perm(fc1.shape[1] // _CHANNELS))
        out[f"{pre}_fea_cv1.weight"] = conv(t["Conv_0"]["kernel"])
        out[f"{pre}_fea_cv1.bias"] = np.asarray(t["Conv_0"]["bias"])
        out[f"{pre}_fea_cv2.weight"] = conv(t["Conv_1"]["kernel"])
        out[f"{pre}_fea_cv2.bias"] = np.asarray(t["Conv_1"]["bias"])
        out[f"{pre}_fc1.weight"] = fc1[:, inv]
        out[f"{pre}_fc1.bias"] = np.asarray(t["Dense_0"]["bias"])
    for name in ("act_fc2", "actor1", "actor2", "crt_fc2", "critic"):
        out[f"{name}.weight"] = dense(p[name]["kernel"])
        out[f"{name}.bias"] = np.asarray(p[name]["bias"])
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}


def torch_to_jax_params(state_dict: dict) -> dict:
    """The port's ``CNNPolicy`` state dict -> the JAX params tree
    ``{"params": {...}}`` of float32 numpy arrays; inverse of
    :func:`jax_params_to_torch`."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
          else np.asarray(v) for k, v in state_dict.items()}
    conv = lambda w: np.transpose(w, (2, 1, 0))
    p: dict = {"logstd": sd["logstd"]}
    for pre in ("act", "crt"):
        fc1 = sd[f"{pre}_fc1.weight"]                       # (256, C * L)
        perm = _flat_perm(fc1.shape[1] // _CHANNELS)
        p[f"{pre}_trunk"] = {
            "Conv_0": {"kernel": conv(sd[f"{pre}_fea_cv1.weight"]),
                       "bias": sd[f"{pre}_fea_cv1.bias"]},
            "Conv_1": {"kernel": conv(sd[f"{pre}_fea_cv2.weight"]),
                       "bias": sd[f"{pre}_fea_cv2.bias"]},
            "Dense_0": {"kernel": fc1[:, perm].T,
                        "bias": sd[f"{pre}_fc1.bias"]}}
    for name in ("act_fc2", "actor1", "actor2", "crt_fc2", "critic"):
        p[name] = {"kernel": sd[f"{name}.weight"].T,
                   "bias": sd[f"{name}.bias"]}
    as_f32 = lambda t: ({k: as_f32(v) for k, v in t.items()}
                        if isinstance(t, dict)
                        else np.ascontiguousarray(t, np.float32))
    return {"params": as_f32(p)}


def save_params_npz(path, params: dict) -> None:
    """Write a params tree (e.g. :func:`torch_to_jax_params`) in the JAX
    ``save_params_npz`` format: one array per leaf, keyed by its key path."""
    flat: dict = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}['{k}']")
        else:
            flat[key] = np.asarray(node)

    walk(params, "")
    np.savez_compressed(path, **flat)
