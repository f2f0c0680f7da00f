"""Device operations (kernels, copies, sets) the host enqueued per update
in the traced window: the count a CUDA graph or a fused kernel lowers."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["units"]:
        return None
    return len(ctx.trace.ops) / ctx.traced["units"]
