"""Milliseconds the card sat idle an acting step, waiting on the step's
launches: the idle gaps of the traced updates that an operation of
``act_step`` (``train/trainer.py::Trainer._rollout``), ``act_policy`` (its
policy forward) or one of ``Env.step``'s spans ends (``benchmark/idle.py``),
over the updates' acting steps.  What a CUDA graph of the whole step could
give back."""
from benchmark import idle

SPANS = ("act_step", "act_policy", "env_step", "env_physics", "env_reset",
         "env_lidar")


def read(ctx):
    if ctx.trace is None or not ctx.traced["env_steps"]:
        return None
    ms = idle.span_ms(ctx.trace, SPANS)
    return None if ms is None else ms / ctx.traced["env_steps"]
