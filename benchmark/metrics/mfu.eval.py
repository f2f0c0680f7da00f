"""Model FLOPs of the untraced window's eval steps over its seconds and
the card's float32 peak, in percent: the actor's forward (actor trunk,
fc2, the two heads) of every robot, all that the mean action needs."""
from benchmark import counts


def read(ctx):
    if not ctx.window["env_steps"]:
        return None
    flops = (ctx.window["env_steps"] * ctx.robots
             * counts.forward(ctx.model, actor_only=True))
    return 100.0 * flops / ctx.window_s / counts.F32_OPS_PER_S
