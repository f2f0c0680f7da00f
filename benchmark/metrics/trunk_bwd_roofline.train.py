"""The trunk backward kernel's share of its roofline in an update,
percent: the least time of both trunks' gradients at each minibatch
(weight gradients, and input gradients of fc1 and conv2; no recomputed
forward; ``counts.py``) over the device time of every operation in the
``twin_trunks_grads`` span (``ops/trunk_cuda.py::TwinTrunks.backward``,
``ops/csrc/trunk_bwd.cu``)."""
from benchmark import counts


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.traced["units"]:
        return None
    phases = tr.phase_of(("twin_trunks_grads",))
    us = sum(t1 - t0 for (_, t0, t1), ph in zip(tr.ops, phases)
             if ph == "twin_trunks_grads")
    if not us:
        return None
    s = counts.update_shape(ctx.cell.config, ctx.cell.traffic)
    least = s["minibatches"] * counts.trunk_grads_call(ctx.model, s["batch"])
    return 100.0 * least * ctx.traced["units"] / (us / 1e6)
