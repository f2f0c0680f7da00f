"""Operations and bytes from shapes, and the peaks they are held against.

Floating-point operations count a multiply-add as 2.  Only the work a
result needs is counted: the forward of what is used, and for gradients
each layer's weight gradient plus the input gradient of every layer whose
input needs one (not the scans').  No recomputed forward counts, so a
program that stops recomputing reads as a gain.  Bytes: each input read
once and each output written once.  Peaks: NVIDIA's H100 SXM data sheet,
dense, at the full 700 W power limit (the run prints the card's limit).
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def _taps(n_in: int, n_out: int, kernel: int, stride: int,
          padding: int) -> int:
    """Kernel taps that land inside the input (padding taps are zeros)."""
    return sum(1 for o in range(n_out) for k in range(kernel)
               if 0 <= stride * o + k - padding < n_in)


def _lengths(model: dict) -> tuple[int, int]:
    c1, c2 = model["conv1"], model["conv2"]
    l1 = (model["beams"] + 2 * c1["padding"] - c1["kernel"]) // c1["stride"] + 1
    l2 = (l1 + 2 * c2["padding"] - c2["kernel"]) // c2["stride"] + 1
    return l1, l2


def trunk_layers(model: dict) -> dict:
    """Multiply-adds per sample of each layer of one trunk."""
    c1, c2 = model["conv1"], model["conv2"]
    l1, l2 = _lengths(model)
    return {"conv1": c1["channels"] * model["frames"]
            * _taps(model["beams"], l1, c1["kernel"], c1["stride"],
                    c1["padding"]),
            "conv2": c2["channels"] * c1["channels"]
            * _taps(l1, l2, c2["kernel"], c2["stride"], c2["padding"]),
            "fc1": model["fc1"] * c2["channels"] * l2}


def trunk_forward(model: dict) -> int:
    """FLOPs per sample through one trunk."""
    return 2 * sum(trunk_layers(model).values())


def trunk_grads(model: dict) -> int:
    """FLOPs per sample of one trunk's gradients: every weight gradient,
    the input gradients of fc1 and conv2, none for conv1's input."""
    mac = trunk_layers(model)
    return 2 * (2 * mac["fc1"] + 2 * mac["conv2"] + mac["conv1"])


def tail_layers(model: dict, actor_only: bool = False) -> int:
    """Multiply-adds per sample of the dense tail: fc2 and the heads of the
    actor, and of the critic unless ``actor_only``."""
    fc2 = (model["fc1"] + 4) * model["fc2"]
    actor = fc2 + 2 * model["fc2"]
    return actor if actor_only else actor + fc2 + model["fc2"]


def forward(model: dict, actor_only: bool = False) -> int:
    """FLOPs per sample of the policy forward: both trunks and the tail,
    or with ``actor_only`` what the mean action needs."""
    trunks = 1 if actor_only else 2
    return trunks * trunk_forward(model) + 2 * tail_layers(model, actor_only)


def gradients(model: dict) -> int:
    """FLOPs per sample of the update's gradients: both trunks', and the
    tail's weight and input gradients."""
    return 2 * trunk_grads(model) + 2 * 2 * tail_layers(model)


def trunk_weights(model: dict) -> int:
    """Parameters of one trunk."""
    c1, c2 = model["conv1"], model["conv2"]
    _, l2 = _lengths(model)
    return (c1["channels"] * (model["frames"] * c1["kernel"] + 1)
            + c2["channels"] * (c1["channels"] * c2["kernel"] + 1)
            + model["fc1"] * (c2["channels"] * l2 + 1))


def least_s(ops: float, nbytes: float) -> float:
    """Least time of a call on the card: operations or bytes, whichever
    takes longer."""
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def trunk_forward_call(model: dict, batch: int, trunks: int = 2) -> float:
    """Least seconds of one trunk-forward call of ``batch`` samples
    through ``trunks`` trunks: float32 scans and weights in, features
    out."""
    scans = batch * model["frames"] * model["beams"]
    nbytes = 4 * (scans + trunks * trunk_weights(model)
                  + trunks * batch * model["fc1"])
    return least_s(trunks * batch * trunk_forward(model), nbytes)


def trunk_grads_call(model: dict, batch: int) -> float:
    """Least seconds of one call of both trunks' gradients: scans, weights
    and the features' cotangent in, the weight gradients out."""
    scans = batch * model["frames"] * model["beams"]
    nbytes = 4 * (scans + 2 * 2 * trunk_weights(model)
                  + 2 * batch * model["fc1"])
    return least_s(2 * batch * trunk_grads(model), nbytes)


#: Lidar operations (``chip_smoke.py``'s count of the plain function): per
#: robot and beam, the beam's rotation (6) and the final minimum and
#: normalize (4); per segment tested, 12; per other robot's disc, 11.
LIDAR_BEAM_OPS, LIDAR_SEGMENT_OPS, LIDAR_DISC_OPS = 10, 12, 11


def lidar_call(robots_per_arena: int, robots: int, beams: int,
               segments_tested: float, n_segments: int) -> float:
    """Least seconds of one lidar frame for ``robots`` robots, each beam
    testing ``segments_tested`` segments (a mean over the robots) and the
    other robots of its arena."""
    per_beam = (LIDAR_BEAM_OPS + LIDAR_SEGMENT_OPS * segments_tested
                + LIDAR_DISC_OPS * (robots_per_arena - 1))
    nbytes = 4 * (3 * robots + 4 * n_segments + 2 * beams + robots * beams)
    return least_s(robots * beams * per_beam, nbytes)


class CellSegments:
    """How many wall segments a beam tests: those of its robot's 1 m cell,
    every segment within ``max_range`` plus the cell's half diagonal of the
    cell's centre (the program's cell table, ``engine/celltable.py``, at
    the cell edge it uses).  A property of where the robots are."""

    CELL = 1.0

    def __init__(self, world: dict):
        seg = np.asarray(world["segments"], np.float32)
        p, e = seg[:, :2], seg[:, 2:]
        lo = np.minimum(p, p + e).min(axis=0)
        hi = np.maximum(p, p + e).max(axis=0)
        self.lo = lo
        self.shape = (max(1, int(np.ceil((hi[0] - lo[0]) / self.CELL))),
                      max(1, int(np.ceil((hi[1] - lo[1]) / self.CELL))))
        nx, ny = self.shape
        centres = np.stack(np.meshgrid(
            lo[0] + (np.arange(nx) + 0.5) * self.CELL,
            lo[1] + (np.arange(ny) + 0.5) * self.CELL, indexing="ij"),
            axis=-1).reshape(-1, 2)
        po = centres[:, None, :] - p[None]
        ee = np.maximum((e * e).sum(-1), 1e-12)
        t = np.clip((po * e[None]).sum(-1) / ee, 0.0, 1.0)
        d = np.linalg.norm(po - t[..., None] * e[None], axis=-1)
        reach = world["max_range"] + self.CELL * np.sqrt(2.0) / 2.0 + 1e-3
        self.counts = (d <= reach).sum(axis=1)

    def mean(self, xy: np.ndarray) -> float:
        """Mean segments tested over positions ``xy`` (..., 2)."""
        nx, ny = self.shape
        ix = np.clip(((xy[..., 0] - self.lo[0]) / self.CELL).astype(np.int64),
                     0, nx - 1)
        iy = np.clip(((xy[..., 1] - self.lo[1]) / self.CELL).astype(np.int64),
                     0, ny - 1)
        return float(self.counts[ix * ny + iy].mean())


def update_shape(config: dict, traffic: dict) -> dict:
    """The calls of one training update: the rollout's and the bootstrap's
    forwards at ``robots`` samples, and each epoch's minibatches."""
    ppo, world = config["ppo"], config["worlds"][traffic["world"]]
    robots = traffic["arenas"] * world["n_robots"]
    batch = ppo["minibatch_per_arena"] * traffic["arenas"]
    return {"robots": robots, "acting_calls": ppo["horizon"] + 1,
            "batch": batch,
            "minibatches": ppo["epochs"] * (ppo["horizon"] * robots // batch)}


def update_flops(config: dict, traffic: dict) -> float:
    """Model FLOPs of one update: every forward of the rollout and the
    bootstrap, and per minibatch the forward and the gradients."""
    s, model = update_shape(config, traffic), config["model"]
    return (s["acting_calls"] * s["robots"] * forward(model)
            + s["minibatches"] * s["batch"]
            * (forward(model) + gradients(model)))
