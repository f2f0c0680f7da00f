"""The trunk forward kernel's share of its roofline in the eval, percent:
the least time of the actor trunk's forward of every robot each step
(the mean action needs no critic; ``counts.py``) over the device time of
the forward kernel's functions (``ops/csrc/trunk_fwd.cu`` and headers)."""
import re

from benchmark import counts

KERNELS = re.compile(r"trunk::(conv_fwd_kernel|gemm_kernel|splitk_reduce)"
                     r"|5trunk(15conv_fwd_kernel|11gemm_kernel|13splitk_reduce)")


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.traced["env_steps"]:
        return None
    us = sum(t1 - t0 for name, t0, t1 in tr.ops if KERNELS.search(name))
    if not us:
        return None
    least = ctx.traced["env_steps"] * counts.trunk_forward_call(
        ctx.model, ctx.robots, trunks=1)
    return 100.0 * least / (us / 1e6)
