"""Device milliseconds an update spends in PPO (``algo/ppo.py``): the
``ppo_forward``, ``twin_trunks_grads`` and ``adam`` spans and the autograd
work outside every span, that is all but the ``rollout`` and ``gae``
spans of the trainer."""

SPANS = ("rollout", "gae", "ppo_forward", "twin_trunks_grads", "adam",
         "grad_all_reduce")


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.traced["units"]:
        return None
    phases = tr.phase_of(SPANS)
    if "ppo_forward" not in phases:
        return None
    ms = sum((t1 - t0) / 1e3 for (_, t0, t1), ph in zip(tr.ops, phases)
             if ph not in ("rollout", "gae"))
    return ms / ctx.traced["units"]
