"""Milliseconds the card sat idle an eval step, waiting on the env's
launches: the idle gaps of the traced call that an operation of
``env_step``, ``env_physics``, ``env_reset`` or ``env_lidar``
(``engine/env.py::Env.step``) ends (``benchmark/idle.py``), over the call's
eval steps.  The env's part of ``step_idle_ms.eval``."""
from benchmark import idle

SPANS = ("env_step", "env_physics", "env_reset", "env_lidar")


def read(ctx):
    if ctx.trace is None or not ctx.traced["env_steps"]:
        return None
    ms = idle.span_ms(ctx.trace, SPANS)
    return None if ms is None else ms / ctx.traced["env_steps"]
