"""The general generator: every input a run hands to the program and to
the reference, drawn from ``--seed`` on the device.

A traffic file (``benchmark/traffic/<name>.json``) names its kind
(``train`` or ``eval``), the configuration's world it runs and its sizes;
what it draws here follows from those.  Training draws the initial
weights (PyTorch's default ranges, U(+-1 / sqrt(fan_in)), one uniform
call for all 2.17 M), the arenas' first poses and goals, and for each
checked update the action noise, the reset samples of every step and the
minibatch order.  The eval loads its weights from the traffic's file and
draws each call's start jitter.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import torch

from .reference import policy as ref_policy
from .reference.world import ring_tables

#: Candidates per robot of the stage-1 goal sampler (``engine/sampling.py``).
GOAL_CANDIDATES = 32


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def weights(model: dict, gen: torch.Generator) -> dict:
    """Initial parameters under the reference's names: U(-b, b) with
    b = 1 / sqrt(fan_in) of the layer, ``logstd`` 0."""
    shapes = ref_policy.shapes(model)
    sizes = {k: math.prod(s) for k, s in shapes.items() if k != "logstd"}
    u = torch.rand(sum(sizes.values()), generator=gen, device=gen.device)
    out, at = {"logstd": torch.zeros(2, device=gen.device)}, 0
    for k, n in sizes.items():
        layer = k.rsplit(".", 1)[0]
        bound = 1.0 / math.sqrt(ref_policy.fan_in(shapes[f"{layer}.weight"]))
        out[k] = ((2.0 * u[at:at + n] - 1.0) * bound).view(shapes[k])
        at += n
    return out


_KEY = re.compile(r"\['([^']*)'\]")


def npz_weights(path: Path, model: dict, device) -> dict:
    """A JAX ``save_params_npz`` file read with numpy, under the
    reference's names and layout: conv (k, in, out) -> (out, in, k), dense
    (in, out) -> (out, in), and fc1's input reordered from flax's
    length-major flatten to the channel-major one."""
    with np.load(path) as data:
        raw = {tuple(_KEY.findall(k)[1:]): data[k] for k in data.files}
    channels = model["conv2"]["channels"]
    out = {"logstd": raw[("logstd",)]}
    for net in ("act", "crt"):
        for layer, name in (("Conv_0", "fea_cv1"), ("Conv_1", "fea_cv2")):
            out[f"{net}_{name}.weight"] = raw[(f"{net}_trunk", layer,
                                               "kernel")].transpose(2, 1, 0)
            out[f"{net}_{name}.bias"] = raw[(f"{net}_trunk", layer, "bias")]
        k = raw[(f"{net}_trunk", "Dense_0", "kernel")]
        length = k.shape[0] // channels
        out[f"{net}_fc1.weight"] = (k.reshape(length, channels, -1)
                                    .transpose(1, 0, 2)
                                    .reshape(k.shape[0], -1).T)
        out[f"{net}_fc1.bias"] = raw[(f"{net}_trunk", "Dense_0", "bias")]
    for name in ("act_fc2", "actor1", "actor2", "crt_fc2", "critic"):
        out[f"{name}.weight"] = raw[(name, "kernel")].T
        out[f"{name}.bias"] = raw[(name, "bias")]
    shapes = ref_policy.shapes(model)
    if {k: tuple(v.shape) for k, v in out.items()} != shapes:
        raise ValueError(f"{path}: not the configuration's network")
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32,
                            device=device) for k, v in out.items()}


def pose_goal(world: dict, arenas: int, gen: torch.Generator):
    """A fresh (pose (A, N, 3), goal (A, N, 2)) for every robot, drawn by
    the world's rule: uniform in the spawn disc with a goal 8-10 m away
    inside it (the first of 32 candidates that lands inside, the first
    candidate pulled in when none does), or the ring's table with x/y
    jittered by U(+-pose_jitter)."""
    shape, dev = (arenas, world["n_robots"]), gen.device
    if world["reset"] == "random_disc":
        radius = world["spawn_radius"]
        u = torch.rand((3, *shape), generator=gen, device=dev)
        r = radius * torch.sqrt(u[0])
        phi, theta = 2.0 * math.pi * u[1], 2.0 * math.pi * u[2]
        pose = torch.stack([r * torch.cos(phi), r * torch.sin(phi), theta],
                           dim=-1)
        lo, hi = world["goal_dist_min"], world["goal_dist_max"]
        u = torch.rand((2, *shape, GOAL_CANDIDATES), generator=gen,
                       device=dev)
        rr = torch.sqrt(lo * lo + u[0] * (hi * hi - lo * lo))
        cand = pose[..., None, :2] + torch.stack(
            [rr * torch.cos(2.0 * math.pi * u[1]),
             rr * torch.sin(2.0 * math.pi * u[1])], dim=-1)
        inside = torch.linalg.vector_norm(cand, dim=-1) <= radius
        first = inside.to(torch.uint8).argmax(dim=-1)
        goal = torch.gather(cand, -2, first[..., None, None].expand(
            *first.shape, 1, 2))[..., 0, :]
        norm = torch.linalg.vector_norm(goal, dim=-1).clamp_min(1e-6)
        return pose, goal * (radius / norm).clamp_max(1.0)[..., None]
    poses, goals = ring_tables(world["n_robots"], world["ring_radius"])
    pose = torch.as_tensor(poses, device=dev).expand(*shape, 3).clone()
    u = torch.rand((*shape, 2), generator=gen, device=dev)
    pose[..., :2] += world["pose_jitter"] * (2.0 * u - 1.0)
    return pose, torch.as_tensor(goals, device=dev).expand(*shape, 2).clone()


def update_draws(world: dict, ppo: dict, arenas: int, gen: torch.Generator):
    """One update's (noise (T, E, 2), resets (T pairs of pose, goal),
    perms (epochs, used))."""
    horizon, e = ppo["horizon"], arenas * world["n_robots"]
    noise = torch.randn((horizon, e, 2), generator=gen, device=gen.device)
    resets = [pose_goal(world, arenas, gen) for _ in range(horizon)]
    m = horizon * e
    used = m // ppo["batch_size"] * ppo["batch_size"]
    perms = torch.stack([torch.randperm(m, generator=gen,
                                        device=gen.device)[:used]
                         for _ in range(ppo["epochs"])])
    return noise, resets, perms


def offsets(arenas: int, n_robots: int, pose_noise: float,
            gen: torch.Generator) -> torch.Tensor:
    """(A, N, 2) start jitter U(+-pose_noise) of one eval call."""
    u = torch.rand((arenas, n_robots, 2), generator=gen, device=gen.device)
    return pose_noise * (2.0 * u - 1.0)
