"""The trunk forward kernel's share of its roofline in an update, percent:
the least time of the forward calls an update needs (both trunks at the
robots, horizon + 1 times, and at each minibatch; ``counts.py``) over the
device time of the forward kernel's functions (``ops/csrc/trunk_fwd.cu``
and its headers) outside the ``twin_trunks_grads`` span."""
import re

from benchmark import counts

KERNELS = re.compile(r"trunk::(conv_fwd_kernel|gemm_kernel|splitk_reduce)"
                     r"|5trunk(15conv_fwd_kernel|11gemm_kernel|13splitk_reduce)")


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.traced["units"]:
        return None
    phases = tr.phase_of(("twin_trunks_grads",))
    us = sum(t1 - t0 for (name, t0, t1), ph in zip(tr.ops, phases)
             if ph is None and KERNELS.search(name))
    if not us:
        return None
    s = counts.update_shape(ctx.cell.config, ctx.cell.traffic)
    least = (s["acting_calls"] * counts.trunk_forward_call(ctx.model,
                                                           s["robots"])
             + s["minibatches"] * counts.trunk_forward_call(ctx.model,
                                                            s["batch"]))
    return 100.0 * least * ctx.traced["units"] / (us / 1e6)
