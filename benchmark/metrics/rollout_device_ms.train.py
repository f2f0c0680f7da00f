"""Device milliseconds an update spends in the trainer's ``rollout`` span
(``train/trainer.py``): the acting steps' policy forwards, samples and env
steps, and the bootstrap value."""

SPANS = ("rollout", "gae", "ppo_forward", "twin_trunks_grads", "adam",
         "grad_all_reduce")


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.traced["units"]:
        return None
    phases = tr.phase_of(SPANS)
    if "rollout" not in phases:
        return None
    ms = sum((t1 - t0) / 1e3 for (_, t0, t1), ph in zip(tr.ops, phases)
             if ph == "rollout")
    return ms / ctx.traced["units"]
