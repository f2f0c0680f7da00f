"""Full-state checkpoints: one ``torch.save`` dict per update directory.

Counterpart of ``rl_collision_avoidance_tpu/utils/checkpoint.py::
CheckpointManager``.  The reference saves only ``policy.state_dict()``
every 20 updates (``ppo_stage1.py:122-126``); here the whole train state is
kept for an exact resume.  What goes into the dict is the trainer's business
(``train/trainer.py::Trainer.state_dict``); the manager stores, lists,
restores and prunes it: ``update_<step>/state.pt``, the newest ``keep``
kept, plus a rolling ``best/state.pt`` chosen by a score.
"""
from __future__ import annotations

import os
import shutil

import torch

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"update_{step}")

    def _steps(self) -> list[int]:
        return sorted(int(name.split("_", 1)[1])
                      for name in os.listdir(self.directory)
                      if name.startswith("update_")
                      and name.split("_", 1)[1].isdigit())

    @staticmethod
    def _write(path: str, payload: dict):
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, _FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, _FILE))

    @staticmethod
    def _read(path: str, device) -> dict:
        return torch.load(os.path.join(path, _FILE), map_location=device,
                          weights_only=True)

    def save(self, step: int, payload: dict):
        self._write(self._path(step), payload)
        for s in self._steps()[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def restore(self, step: int, device=None) -> dict:
        """The dict saved at ``step``, its tensors on ``device``."""
        return self._read(self._path(step), device)

    def latest_step(self) -> int | None:
        steps = self._steps() if os.path.isdir(self.directory) else []
        return steps[-1] if steps else None

    def save_best(self, step: int, payload: dict, score: float) -> bool:
        """Keep a rolling best checkpoint by a scalar score (e.g. the goal
        share of ended episodes); returns True when it improved."""
        marker = os.path.join(self.directory, "best_score")
        if os.path.exists(marker):
            with open(marker) as f:
                if score <= float(f.read().split()[0]):
                    return False
        self._write(os.path.join(self.directory, "best"), payload)
        with open(marker, "w") as f:
            f.write(f"{score} {step}\n")
        return True

    def restore_best(self, device=None) -> dict:
        return self._read(os.path.join(self.directory, "best"), device)
