"""Profiling and debugging aids: the port's counterparts of
``rl_collision_avoidance_tpu/utils/profiling.py`` (``trace``,
``nan_debug``, ``StepTimer``), and ``span``, the one way the port marks
its phases in a trace.

Usage::

    with trace("/tmp/rca-trace"):      # Chrome / TensorBoard trace, a rank
        trainer.train(updates=3)

    with span("env_step"):             # a range in any running profiler's
        ...                            # trace; a flag read otherwise

    with nan_debug():                  # raise at the first NaN a backward
        trainer.train(updates=1)       # produces
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from ..parallel.dist import rank

_OFF = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler runs, and
    a shared no-op context otherwise: an unwatched range costs a flag read,
    not the host time of a range (about that of two small ops).  The flag is the Python profiler's
    module state, which every thread sees (autograd's device thread runs
    ``twin_trunks_grads``; the C-level check reads False there)."""
    if autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` (host ops, and the
    card's kernels and copies where there is a card) and write it into
    ``log_dir`` as ``rank<r>.pt.trace.json``, one file a rank, which
    Chrome's ``chrome://tracing``, Perfetto and TensorBoard's profiler
    plugin read."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir,
                                              f"rank{rank()}.pt.trace.json"))


@contextlib.contextmanager
def nan_debug():
    """Autograd's anomaly mode with its NaN check inside the block (the
    counterpart of ``jax_debug_nans``): a backward function that returns a
    NaN raises, naming the forward op that made it; the previous mode is
    restored on exit."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield


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
