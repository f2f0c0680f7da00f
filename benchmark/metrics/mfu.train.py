"""Model FLOPs of the untraced window's updates over its seconds and the
card's float32 peak (67 TFLOP/s), in percent: every forward of the
rollout and the bootstrap through both trunks and the tail, and per
minibatch the forward and the gradients.  No recomputed work counts."""
from benchmark import counts


def read(ctx):
    if not ctx.window["units"]:
        return None
    flops = ctx.window["units"] * counts.update_flops(ctx.cell.config,
                                                      ctx.cell.traffic)
    return 100.0 * flops / ctx.window_s / counts.F32_OPS_PER_S
