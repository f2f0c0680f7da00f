"""Share of the traced window in which no operation ran on the card, in
percent: 1 - busy / window, busy the union of the device operations."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)
