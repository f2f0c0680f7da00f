"""Milliseconds the card sat idle an acting step, waiting on the reset
sampler's launches: the idle gaps of the traced updates that an operation
of ``env_sample`` (``engine/env.py::Env.sample_pose_goal`` inside
``env_reset``) ends (``benchmark/idle.py``), over the updates' acting
steps.  Nothing where the program has no such span."""
from benchmark import idle

SPANS = ("env_sample",)


def read(ctx):
    if ctx.trace is None or not ctx.traced["env_steps"]:
        return None
    ms = idle.span_ms(ctx.trace, SPANS)
    return None if ms is None else ms / ctx.traced["env_steps"]
