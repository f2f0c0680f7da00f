"""Throwaway cells for the harness's CPU tests, written as files into a
directory beside the harness's own: a configuration of the ``mini``
world (4 robots, 64 beams, the 20 m square), its training traffic, an
eval traffic of one circle arena, their limits and a ``BENCHMARK.json``.
Drivers and metrics are the harness's own files, linked in."""
from __future__ import annotations

import copy
import json
import os
from pathlib import Path

from benchmark import spec

HARNESS = spec.HERE
SQUARE = [[-10.0, -10.0, 20.0, 0.0], [10.0, -10.0, 0.0, 20.0],
          [10.0, 10.0, -20.0, 0.0], [-10.0, 10.0, 0.0, -20.0]]


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """A harness root under ``tmp`` with the cells ``mini-train`` and
    ``circle-eval-1``; returns the path of its ``BENCHMARK.json``."""
    root = tmp / "bench"
    for sub in ("drivers", "metrics", "reference", "data"):
        (root / sub).parent.mkdir(parents=True, exist_ok=True)
        os.symlink(HARNESS / sub, root / sub)
    stage1 = _read(HARNESS / "configs" / "stage1.json")
    mini = copy.deepcopy(stage1)
    mini["name"] = "mini"
    mini["model"]["beams"] = 64
    mini["worlds"]["train"].update(name="mini", n_robots=4, segments=SQUARE)
    mini["ppo"].update(horizon=32, minibatch_per_arena=64)
    _write(root / "configs" / "mini.json", mini)
    _write(root / "configs" / "circle50.json",
           _read(HARNESS / "configs" / "circle50.json"))
    _write(root / "traffic" / "train-mini.json",
           {"kind": "train", "world": "train", "arenas": 2})
    _write(root / "traffic" / "eval-1arena.json",
           {"kind": "eval", "world": "eval", "arenas": 1,
            "pose_noise_m": 0.1, "max_steps": 600,
            "weights": "data/circle_ft_params.npz"})
    limits = limits or {}
    _write(root / "limits" / "mini-train.json", limits.get(
        "mini-train", {"loss_gap": 1e-5, "grad_gap": 1e-4,
                       "change_gap": 0.06, "change_gap_worst": 0.3,
                       "reset_rule_share": 1e-2}))
    _write(root / "limits" / "circle-eval-1.json", limits.get(
        "circle-eval-1", {"output_gap": 1e-4}))
    bench = _read(spec.REPO / "BENCHMARK.json")
    bench["configs"] = [
        {"name": "mini", "source": "test", "file": "configs/mini.json",
         "reduced": [], "why": "test"}]
    bench["workloads"] = [
        {"name": "mini-train", "config": "mini", "traffic": "train-mini",
         "chips": 1, "why": "test"},
        {"name": "circle-eval-1", "config": "circle50",
         "traffic": "eval-1arena", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["mini-train" if "train" in w else
                              "circle-eval-1" for w in m["workloads"]]
            m["workloads"] = sorted(set(m["workloads"]))
    _write(root / "BENCHMARK.json", bench)
    return root / "BENCHMARK.json"


def load(tmp_bench: Path, cell: str):
    return spec.load(cell, tmp_bench, tmp_bench.parent)
