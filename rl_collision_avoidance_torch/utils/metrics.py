"""Structured metrics with the reference's three log streams as a floor.

The reference writes ``log/<hostname>/output.log`` (per-episode lines),
``cal.log`` (bare episode rewards) and ``ppo.log`` (policy/value/entropy per
minibatch) — ``ppo_stage1.py:137-162``, ``model/ppo.py:10-19``.  Batched
arenas make per-episode host lines impractical, so the same information is
emitted as per-update aggregates, plus a machine-readable ``metrics.csv``.

The port's own copy of ``rl_collision_avoidance_tpu/utils/metrics.py``
(framework-free), so the two packages write the same files.
"""
from __future__ import annotations

import csv
import logging
import os
import socket
import sys


class MetricLogger:
    def __init__(self, log_dir: str | None = None, stdout: bool = True):
        if log_dir is None:
            log_dir = os.path.join("log", socket.gethostname())
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir

        self.output = logging.getLogger("rca.output")
        self.cal = logging.getLogger("rca.cal")
        self.ppo = logging.getLogger("rca.ppo")
        for lg, fname in ((self.output, "output.log"), (self.cal, "cal.log"),
                          (self.ppo, "ppo.log")):
            lg.setLevel(logging.INFO)
            lg.propagate = False
            # the named loggers are process-global: re-point any previous
            # instance's file handlers at THIS logger's directory
            for h in list(lg.handlers):
                if isinstance(h, logging.FileHandler):
                    lg.removeHandler(h)
                    h.close()
            h = logging.FileHandler(os.path.join(log_dir, fname), mode="a")
            h.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
            lg.addHandler(h)
        if stdout and not any(isinstance(h, logging.StreamHandler)
                              and not isinstance(h, logging.FileHandler)
                              for h in self.output.handlers):
            sh = logging.StreamHandler(sys.stdout)
            self.output.addHandler(sh)

        self._csv_path = os.path.join(log_dir, "metrics.csv")
        self._csv_fields = None

    def log_update(self, m: dict):
        ep = max(int(m.get("episodes", 0)), 1)
        mean_ret = float(m.get("ep_return_sum", 0.0)) / ep
        self.output.info(
            "Update %05d, Episodes %4d, MeanReturn %7.2f, Reached %4d, "
            "Crashed %4d, Reward/step %6.3f, %7.0f steps/s, graphs %d "
            "captured, %d replayed"
            % (m.get("update", 0), m.get("episodes", 0), mean_ret,
               m.get("reached", 0), m.get("crashed", 0),
               m.get("reward_mean", 0.0), m.get("steps_per_s", 0.0),
               m.get("graph_captures", 0), m.get("graph_replays", 0)))
        self.cal.info("%s" % mean_ret)
        self.ppo.info("%s, %s, %s" % (m.get("policy_loss"),
                                      m.get("value_loss"), m.get("entropy")))
        row = {k: (float(v) if hasattr(v, "__float__") else v)
               for k, v in m.items()}
        write_header = self._csv_fields is None
        if write_header:
            self._csv_fields = sorted(row)
        with open(self._csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_fields,
                               extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)
