"""Device operations (kernels, copies, sets) the host enqueued per eval
step in the traced calls (their resets and start jitter included)."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["env_steps"]:
        return None
    return len(ctx.trace.ops) / ctx.traced["env_steps"]
