"""The numbers that decide ``correct``, and their limits.

Training: the loss of the first checked update's first minibatch (its
first optimizer step), the first gradient as the optimizer got it, and
the parameters' change over the checked updates, each program against
reference.  The gap of a leaf is the gap between the two sides' norms of
it over the larger of the reference's norm of that leaf and of the median
leaf.  The gradient is compared by its worst leaf; the change by its
median leaf, and the loss at the first step alone: the later updates'
rollouts part where a crash is decided on rounding, and Adam's +-lr steps
on the elements with near-zero gradients carry rounding into every later
minibatch's loss and make the worst leaf's change follow that noise.
Leaves whose reference gradient is
under a thousandth of the median leaf's move by rounding alone, and are
left out of the change.
Eval (``reference/circle.py``, which follows the program's states):
``output_gap``, the largest of the action gap, the state gap and the
share of the sampled robots whose answers differ; the control (a lower
precision of the policy) moves only the first, the faults the others.
"""
from __future__ import annotations

import math
import statistics
import sys

import torch

#: A leaf whose reference gradient norm is under this share of the median
#: leaf's is not held to the change.
STILL_LEAF = 1e-3


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def leaf_gaps(prog: dict, ref: dict, keys=None) -> dict:
    """| |prog_k| - |ref_k| | / max(|ref_k|, median |ref|) of each leaf k of
    ``keys``; inf where a leaf is missing or not finite."""
    keys = list(ref) if keys is None else list(keys)
    if not keys or any(k not in prog for k in keys):
        return {"missing": math.inf}
    p, r = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in keys})
    med = statistics.median(r.values())
    gaps = {k: abs(p[k] - r[k]) / max(r[k], med) for k in keys}
    return {k: g if math.isfinite(g) else math.inf for k, g in gaps.items()}


def _worst(gaps: dict) -> tuple:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def train_readings(losses, ref_losses, first, ref_first, params0, params_end,
                   ref_params_end) -> dict:
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    if len(losses) != len(ref_losses) or not all(map(math.isfinite,
                                                     loss_gaps)):
        loss_gaps = [math.inf]
    med = statistics.median(_norms(ref_first).values()) if ref_first else 0.0
    moving = [k for k, n in _norms(ref_first).items() if n >= STILL_LEAF * med]
    change = lambda end: {k: end[k] - params0[k] for k in end}
    grad, grad_leaf = _worst(leaf_gaps(first, ref_first))
    changes = leaf_gaps(change(params_end), change(ref_params_end), moving)
    worst, worst_leaf = _worst(changes)
    return {"loss_gap": loss_gaps[0], "grad_gap": grad,
            "change_gap": statistics.median(changes.values()),
            "loss_gaps": loss_gaps, "grad_leaf": grad_leaf,
            "change_gap_worst": worst, "change_leaf": worst_leaf,
            "still_leaves": len(ref_first) - len(moving)}


def eval_readings(action_gap: float, state_gap: float,
                  answer_mismatch: float) -> dict:
    return {"output_gap": max(action_gap, state_gap, answer_mismatch),
            "action_gap": action_gap, "state_gap": state_gap,
            "answer_mismatch": answer_mismatch}


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names; a number missing or not finite fails."""
    out = {}
    ok = True
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        value = value if math.isfinite(value) else math.inf
        ok &= value <= limit
        out[name] = {"value": value if math.isfinite(value) else None,
                     "limit": limit}
    return bool(ok), out


def print_limits(compared: dict, stream=sys.stderr) -> None:
    for name, v in compared.items():
        print(f"{name} {v['value']} limit {v['limit']}", file=stream,
              flush=True)
