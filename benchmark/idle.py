"""The card's idle time of a traced window, put down to the program's
spans: each idle gap goes to the span of the operation that ends it, the
launch the card was waiting for.

The gaps are ``trace.reduce``'s, between one operation's end (the latest
so far) and the next one's start; the gap before the window's first
operation is left out, since a ``Trace`` keeps no window start, and the
gap after the last has no operation to end it.  An operation's span is
``Trace.phase_of``'s, the innermost (shortest) device-side span among the
given names that contains its start, found here in one sweep over the
operations in start order rather than one search of the spans each.
"""
from __future__ import annotations

import collections
import heapq


def by_span(trace, names) -> dict:
    """Idle milliseconds by the span (among ``names``; None outside all)
    of the operation that ends each gap."""
    spans = sorted((lo, hi - lo, i, hi, name) for i, (name, lo, hi)
                   in enumerate(trace.spans) if name in names)
    out = collections.Counter()
    active, nxt, at = [], 0, None
    for _, t0, t1 in trace.ops:
        if at is not None and t0 > at:
            while nxt < len(spans) and spans[nxt][0] <= t0:
                _, length, i, hi, name = spans[nxt]
                heapq.heappush(active, (length, i, hi, name))
                nxt += 1
            while active and active[0][2] < t0:
                heapq.heappop(active)
            out[active[0][3] if active else None] += (t0 - at) / 1e3
        at = t1 if at is None else max(at, t1)
    return dict(out)


def span_ms(trace, names) -> float | None:
    """Idle milliseconds ended by an operation of a span among ``names``;
    None where the trace has none of those spans."""
    if not any(name in names for name, _, _ in trace.spans):
        return None
    return sum(ms for name, ms in by_span(trace, names).items()
               if name is not None)
