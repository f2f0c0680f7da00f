"""A traced window: torch.profiler over a fixed amount of the cell's work,
reduced to device operations, device-side spans and the host's activity.

A device operation is a kernel, copy or set on the card; a device-side
span is a ``record_function`` range of the program as the card saw it,
from the first to the last operation launched inside it.  All work runs
on one stream in launch order, so an operation belongs to the innermost
span that contains its start.  The window is the benchmark's own span
around the work, ending in a synchronize; busy time is the union of the
operations inside it.  Each idle gap is named by what the host was doing
at its middle: the innermost host event then, on any thread.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time

import torch

WINDOW = "benchmark_traced_window"
#: Characters of an operation or host event name kept in a breakdown.
NAME = 100


@dataclasses.dataclass
class Trace:
    ops: list          # (name, start_us, end_us), sorted by start
    spans: list        # (name, start_us, end_us) device-side spans
    window_us: float
    busy_us: float
    gaps: dict         # host activity -> idle seconds
    reduce_s: float = 0.0  # host seconds this reduction took

    def phase_of(self, names) -> list:
        """Each op's innermost span among ``names`` (None outside all)."""
        spans = sorted((s for s in self.spans if s[0] in names),
                       key=lambda s: s[2] - s[1])
        return [next((n for n, lo, hi in spans if lo <= t0 <= hi), None)
                for _, t0, _ in self.ops]

    def op_seconds(self, top: int = 10) -> list:
        total = collections.Counter()
        for name, t0, t1 in self.ops:
            total[name[:NAME]] += (t1 - t0) / 1e6
        return [[k, v] for k, v in total.most_common(top)]

    def gap_seconds(self, top: int = 10) -> list:
        return [[k, v] for k, v in
                collections.Counter(self.gaps).most_common(top)]


def record(fn):
    """(fn(), Trace) of ``fn`` run under torch.profiler on the card; the
    profiler's raw events are read, without building its event tree."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = reduce(prof.profiler.kineto_results.events())
    trace.reduce_s = time.perf_counter() - t0
    return out, trace


def reduce(events) -> Trace:
    """A Trace of the profiler's raw events (times in ns, kept in us)."""
    from torch.autograd import DeviceType

    ops, spans, host, window = [], [], [], None
    for e in events:
        t0, t1 = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            (spans if e.is_user_annotation() else ops).append(
                (e.name(), t0, t1))
        elif e.name() == WINDOW:
            window = (t0, t1)
        else:
            host.append((t0, t1, e.start_thread_id(), e.name()))
    if window is None:
        raise RuntimeError("the traced window's span is missing")
    lo, hi = window
    ops = sorted((o for o in ops if lo <= o[1] <= hi), key=lambda o: o[1])
    busy, gaps, at = 0.0, [], lo
    for _, t0, t1 in ops:
        if t0 > at:
            gaps.append((at, t0))
        busy += max(0.0, min(t1, hi) - max(t0, at))
        at = max(at, t1)
    if hi > at:
        gaps.append((at, hi))
    return Trace(ops=ops, spans=spans, window_us=hi - lo, busy_us=busy,
                 gaps=_name_gaps(gaps, host))


def _name_gaps(gaps, host) -> dict:
    """Idle seconds by the innermost host event at each gap's middle."""
    host.sort(key=lambda h: (h[0], -h[1]))    # outer before inner
    starts = [h[0] for h in host]
    stacks: dict = collections.defaultdict(list)
    named = collections.Counter()
    pushed = 0
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        upto = bisect.bisect_right(starts, mid)
        for h in host[pushed:upto]:
            stack = stacks[h[2]]
            while stack and stack[-1][1] <= h[0]:
                stack.pop()
            stack.append(h)
        pushed = max(pushed, upto)
        best = None
        for stack in stacks.values():
            while stack and stack[-1][1] < mid:
                stack.pop()
            if stack and (best is None or stack[-1][0] > best[0]):
                best = stack[-1]
        name = best[3][:NAME] if best else "host outside the program's ops"
        named[name] += (g1 - g0) / 1e6
    return dict(named)
