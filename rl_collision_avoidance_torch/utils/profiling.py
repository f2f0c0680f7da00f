"""Step timing for the host loop (the port's copy of
``rl_collision_avoidance_tpu/utils/profiling.py::StepTimer``)."""
from __future__ import annotations

import time


class StepTimer:
    """Wall-clock EMA of step latency; env-steps/s is the north-star metric.
    The caller ends each timed step with a host synchronization (reading the
    step's metrics), so the time covers the device work."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = None
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int) -> float:
        dt = time.perf_counter() - self._t0
        rate = n_steps / dt
        self.ema = rate if self.ema is None else (
            self.alpha * rate + (1 - self.alpha) * self.ema)
        return rate
