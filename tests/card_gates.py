"""The gates that hold the port's CUDA paths to their plain versions.

Tolerances, goal and success floors, and the helpers that apply them: the
card's tests (``tests/test_torch_gpu.py`` and the ranks it starts through
``tests/torch_dist_worker.py``) hold the kernels and the curriculum's paths
by them, and the bf16 CPU tests hold the plain versions to the JAX package
by the same rules.  Imports torch, numpy and the port, never JAX: the card's
machine has none.
"""
import contextlib
import re
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.nn.grad import conv1d_input, conv1d_weight

from rl_collision_avoidance_torch.ops import env_cuda, lidar_cuda, trunk_cuda
from rl_collision_avoidance_torch.utils import graphs

LIDAR_ATOL = 1e-5     # normalized obs, as tests/test_pallas.py holds the TPU kernel
# The trunk kernel sums its 4096-long fc1 dot products (and the 96- and
# 15-long conv sums) in another order than cuBLAS/cuDNN; the rounding error
# of such a sum is ~sqrt(n) * 2^-24 * sum|terms| ~ 1e-5 at these weights, so
# 1e-4 absolute plus 1e-4 relative leaves room without hiding a wrong
# weight, tap or layout (those give errors of order 1).
TRUNK_ATOL = TRUNK_RTOL = 1e-4
POLICY_ATOL = 1e-4    # actions and values through the trunk features
# The trunk backward kernel against the plain version in float64: each
# gradient element within BWD_TOL of the sum of the absolute values of its
# terms (the same backward on |g|, |W|, |x|).  A float32 sum of n terms taken
# in sequence errs by about 2^-24 sqrt(n / 3) of that sum even when all terms
# share a sign: 6e-6 for the 32,768-long batch sums of dWf and dbf, less for
# the blocked sums of the conv gradients.  An fc1 ReLU whose pre-activation
# lies within BWD_TOL of its own |terms| sum may fall either way in float32;
# the whole of every term behind such a ReLU is added to the limit.
BWD_TOL = 1e-5
# A minibatch's parameter gradients through the kernels against the plain
# path's: the forward kernel's features differ from cuDNN's by up to
# TRUNK_ATOL, which moves every cotangent of the loss; each leaf within
# GRAD_ATOL of its largest value, and within GRAD_NORM in relative 2-norm.
# Held on GRAD_MINIBATCHES minibatches of each training path.
GRAD_ATOL = 1e-3
GRAD_NORM = 1e-4
GRAD_MINIBATCHES = 3
# A bf16 policy's dense tail (fc2 and the heads) gives its weights bf16
# gradients, as JAX's bf16 dense does: each element is the bf16 rounding of
# float32 sums that the two paths take over nearly the same terms, so it is
# bit-equal or, where the rounding falls the other way, one bf16 ulp apart.
# Those leaves hold, per element, GRAD_ATOL of the largest value or one ulp
# of their own (BF16_ULP), and BF16_ULP in relative 2-norm (the most even
# every element one ulp apart gives).  The check sums both paths' bf16
# products in float32 (float32_sums); PyTorch's default lets cuBLAS add
# split-K partials in bf16, another rounding on each side.  The trunk
# leaves (float32, from the kernels) and logstd hold the float32 rule.
TRUNK_LEAVES = ("act_fea", "crt_fea", "act_fc1", "crt_fc1", "logstd")
# The loss is piecewise: the ReLUs of the convs and fc1 (in the trunks) and
# of fc2 (in the heads), and the PPO clip.  A sample whose pre-activation
# lies within the two paths' forward difference of 0 takes another piece on
# each path, and its whole term of the leaves behind that ReLU differs; on
# a leaf whose gradient nearly cancels over the minibatch one such sample
# is enough to break the rule (at the circle fine-tune one sample's conv2
# ReLU moves the actor's conv gradients by ~1.5e-3).  Such samples are
# counted, at most MAX_FLIP_SHARE of a minibatch, and weighted 0 on both
# paths; the rule above holds on the rest.  Measured: 5 to 23 samples a
# minibatch (stage 1: 15-23 of 32,768; stage 2: 5-6 of 8,192; the
# fine-tune: 5-10 of 10,240), nearly all at a conv ReLU.
MAX_FLIP_SHARE = 5e-3
# At the circle fine-tune the losses nearly cancel over a minibatch: the
# trained critic's residuals sum to 2.8% of their absolute sum or less
# (0.09% in one minibatch), so the critic's gradients are small differences
# of large sums, which float32 resolves only to a share of those sums: each
# critic leaf's |terms| scale (float64_grads) is 12 to 1,160 times its
# gradient, and the float32 plain path itself lies up to 5e-6 of that scale
# from the float64 gradient, beyond GRAD_NORM of the gradient.  So the rule
# above cannot hold between two float32 paths there.  On that path a leaf
# that misses it is held to the float64 plain path instead, within
# GRAD_ATOL and GRAD_NORM of its |terms| scale, as BWD_TOL is of the
# |terms| sum (the kernel path read 5.1e-6 to 7.6e-6).
# The bf16 mode (trunk_cuda precision="bf16", CNNPolicy(dtype=bfloat16),
# bf16 scans).  The kernels and the plain bf16 versions round every product
# operand and every output to bf16 at the same points and add the same
# exact products in float32, in other orders.  So an output is bit-equal on
# the two paths, or, where its float32 value lies within the paths'
# float32 difference (~1e-6 of it) of a bf16 rounding boundary, one bf16 ulp
# apart; an ulp is at most BF16_ULP of the value.  Such rounding flips are
# counted: the outputs beyond the float32 rule must each lie within one ulp
# (plus that rule's absolute part, for a ReLU at zero), and number at most
# BF16_FLIP_SHARE of the outputs.  Expected: ~1e-3 of the features (2 x
# 1e-6 / 2^-8 at the fc1 output, plus flips carried from the conv roundings
# before it); read on the CPU (plain bf16 trunks in float32 against float64):
# 5e-5 of the features with the trained stage-1 weights, 8e-4 with random
# weights, and no flipped value or mean.  In a gradient, a rounding that
# falls the other way on the two paths moves each term it enters by at most
# one ulp of one factor: an element beyond the float32 rule (BWD_TOL of its
# |terms| sum) must lie within BF16_ULP of that sum, and such elements number
# at most BF16_FLIP_SHARE of a leaf.  In a training minibatch a sample whose
# value or mean differs between the two paths counts as taking another
# piece (MAX_FLIP_SHARE).
BF16_ULP = 2.0 ** -7
BF16_FLIP_SHARE = 1e-2
# MLPPolicy on the card against the CPU: a forward and the gradient of a
# mean loss over MLP_BATCH observations of MLP_OBS inputs (3 x 512 scan
# beams, goal and speed), exact float32 (no TF32) on both.
MLP_ATOL = 1e-5

# Goal and success floors of the trained weights on the card.
S1_MIN_GOAL = 0.5     # the JAX training run's stage-1 plateau is ~0.85
# the stage-1 gate of the one-process training slice
MP_MIN_GOAL = S1_MIN_GOAL
S2_MIN_GOAL = 0.20    # results/stage2_metrics.csv reads 0.43, 0.58 at updates 1-2
EVAL_MIN_SUCCESS = 0.90   # the committed TPU value is 0.994375
# The rect footprint's committed TPU outcomes (results/circle_eval_rect.json):
# the ring at success 1.0 with 0 collisions, culled to the 12 nearest at
# 1.0, and 16 arenas at 0.3 m at a success mean of 0.835 with a std of
# 0.195 over the arenas, a standard error of ~0.049: 0.70 lies about three
# of them below.
RECT_RING = {"success_rate": 1.0, "collisions": 0}
RECT_MIN_SUCCESS = 0.70


def flip_check(diff, tight, loose, what: str) -> int:
    """The bf16 rule for outputs or gradient elements: where ``diff``
    exceeds ``tight`` (the float32 rule) it must stay within ``loose`` (one
    bf16 ulp), at no more than BF16_FLIP_SHARE of the elements; returns how
    many exceed ``tight``."""
    over = diff > tight
    n = int(over.sum())
    if not bool((diff <= loose).all()) or n > BF16_FLIP_SHARE * diff.numel():
        raise AssertionError(f"{what}: {n} of {diff.numel()} elements beyond "
                             f"the float32 rule (limit "
                             f"{BF16_FLIP_SHARE * diff.numel():.0f}), the "
                             f"worst {float((diff - loose).max()):.3g} beyond "
                             f"one bf16 ulp")
    return n


def check_features(got, want, precision: str, what: str) -> int:
    """Trunk features of the kernel against its plain version: float32 within
    TRUNK_ATOL + TRUNK_RTOL |want|; bf16 by :func:`flip_check`.  Returns the
    bf16 rounding flips (0 in float32)."""
    diff = (got.float() - want.float()).abs()
    tight = TRUNK_ATOL + TRUNK_RTOL * want.float().abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite features")
    if precision == "float32":
        if not bool((diff <= tight).all()):
            raise AssertionError(f"{what}: differs from its plain version by "
                                 f"{float(diff.max())} (atol {TRUNK_ATOL}, "
                                 f"rtol {TRUNK_RTOL})")
        return 0
    return flip_check(diff, tight, TRUNK_ATOL + BF16_ULP * want.float().abs(),
                      what)


def trunk_grads_limits(scans, act, crt, g, precision: str = "float32"):
    """For each trunk, two tuples of six float64 limits for the weight
    gradients' float32 rounding: the sum of the absolute values of each
    gradient's terms, and what the ReLUs that float32 may turn either way
    contribute.

    The first is the backward on absolute values: |g|, |W|, and in place of
    each activation the sum of the absolute values of its forward terms,
    which bounds the activation's own rounding as well; a ReLU whose
    pre-activation lies within BWD_TOL of that sum counts as open.  Such a
    ReLU near zero may flip, and then moves its whole term: at fc1 every
    gradient's term of that sample (one of the batch's 32,768), at conv2
    the terms of dW2, db2, dW1 and db1 through that unit, at conv1 those of
    dW1 and db1; the second tuple is the absolute-value backward through the
    near ReLUs of each layer alone.  In bf16 mode the forward rounds its
    operands as the kernels do, so that the pre-activations are the bf16
    function's."""
    rnd = trunk_cuda.round_bf16 if precision == "bf16" else (lambda v: v)
    x = rnd(scans.double())
    xa = x.abs()
    out = []
    for t, ws in enumerate((act, crt)):
        w1, b1, w2, b2, wf, bf = (w.double() for w in ws)
        w1, w2, wf = rnd(w1), rnd(w2), rnd(wf)
        open_ = lambda z, za: z > -BWD_TOL * za
        near_ = lambda z, za: z.abs() <= BWD_TOL * za
        z1 = F.conv1d(x, w1, b1, stride=2, padding=1)
        z1a = F.conv1d(xa, w1.abs(), b1.abs(), stride=2, padding=1)
        m1, near1 = open_(z1, z1a), near_(z1, z1a)
        y1a = z1a * m1
        z2 = F.conv1d(rnd(z1.clamp(min=0)), w2, b2, stride=2, padding=1)
        z2a = F.conv1d(y1a, w2.abs(), b2.abs(), stride=2, padding=1)
        m2, near2 = open_(z2, z2a), near_(z2, z2a)
        flat_a = (z2a * m2).flatten(1)
        z3 = F.linear(rnd(z2.clamp(min=0).flatten(1)), wf, bf)
        z3a = F.linear(flat_a, wf.abs(), bf.abs())
        ga = g[t].double().abs()
        near3 = near_(z3, z3a)

        def grads(g1, g2, g3):  # the absolute-value trunk's weight gradients
            return (conv1d_weight(xa, w1.shape, g3, stride=2, padding=1),
                    g3.sum((0, 2)),
                    conv1d_weight(y1a, w2.shape, g2, stride=2, padding=1),
                    g2.sum((0, 2)), g1.T @ flat_a, g1.sum(0))

        to_z2 = lambda g1: (g1 @ wf.abs()).view_as(z2)
        to_z1 = lambda g2: conv1d_input(z1.shape, w2.abs(), g2, stride=2,
                                        padding=1)
        g1 = ga * open_(z3, z3a)
        g2 = to_z2(g1) * m2
        scale = grads(g1, g2, to_z1(g2) * m1)
        g1n = ga * near3
        g2n = to_z2(g1n) * m2
        fc1 = grads(g1n, g2n, to_z1(g2n) * m1)
        g2c = to_z2(g1) * near2
        conv2 = grads(torch.zeros_like(g1), g2c, to_z1(g2c) * m1)
        conv1 = grads(torch.zeros_like(g1), torch.zeros_like(g2),
                      to_z1(g2) * near1)
        out.append((scale, tuple(a + b + c for a, b, c in
                                 zip(fc1, conv2, conv1))))
    return out


def check_grads(got, want, limits, precision: str, what: str) -> int:
    """Gradients (12 leaves, actor then critic) against the float64 plain
    version ``want``, with ``limits`` from :func:`trunk_grads_limits`: each
    element within BWD_TOL of its |terms| sum plus its near-ReLU terms; in
    bf16 by :func:`flip_check`, beyond that within BF16_ULP of the sum.
    Returns the elements beyond the float32 rule."""
    scale, near = ([*x[0], *x[1]] for x in zip(*limits))
    names = [f"{t}.{n}" for t in ("act", "crt")
             for n in trunk_cuda.WEIGHT_NAMES]
    flips = 0
    for name, k, w, sc, nz in zip(names, got, want, scale, near):
        diff = (k.double() - w).abs()
        tight = BWD_TOL * sc + nz
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{what}: non-finite gradient of {name}")
        if precision == "bf16":
            flips += flip_check(diff, tight, tight + BF16_ULP * sc,
                                f"{what}, {name}")
        elif not bool((diff <= tight).all()):
            raise AssertionError(f"{what} differs from the float64 plain "
                                 f"version on {name} by more than {BWD_TOL} "
                                 f"of its |terms| sum")
    return flips


@contextlib.contextmanager
def float32_sums():
    """bf16 products on the card with float32 sums throughout (no bf16
    split-K reduction in cuBLAS), restoring the setting on exit."""
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            prev)


def conv_pieces(scans, act, crt, kernel: bool, precision: str = "float32"):
    """(2, B, 3 * 4,096) booleans: per trunk and sample, which conv2 ReLUs
    and which conv1 ReLUs (even positions, then odd) pass.  ``kernel``: as
    the kernels compute them, read through the forward kernel with selector
    weights: fc1 rows of the identity pass 256 of the 4,096 conv2 features
    unchanged, conv2 taps of the identity pass conv1's even or odd
    positions (exact in float32: one product by 1, the rest sums of
    zeros; in bf16 too, and rounding keeps the sign).  Otherwise as the
    plain trunks compute them."""
    dev = scans.device
    taps = lambda t: (torch.eye(32, device=dev)[:, :, None]
                      * (torch.arange(3, device=dev) == t))
    zero = torch.zeros(32, device=dev)
    if not kernel:
        out = []
        r = trunk_cuda.round_bf16
        with trunk_cuda.exact_float32():
            for w1, b1, w2, b2, _, _ in (act, crt):
                if precision == "bf16":
                    y1 = F.relu(F.conv1d(r(scans.float()), r(w1), stride=2,
                                         padding=1) + b1[:, None])
                    y2 = F.relu(F.conv1d(r(y1), r(w2), stride=2, padding=1)
                                + b2[:, None])
                else:
                    y1 = F.relu(F.conv1d(scans, w1, b1, stride=2, padding=1))
                    y2 = F.relu(F.conv1d(y1, w2, b2, stride=2, padding=1))
                odd = F.pad(y1, (1, 0))[:, :, 0::2]     # y1[c, 2m - 1]
                out.append(torch.cat([y2.flatten(1), y1[:, :, 0::2].flatten(1),
                                      odd.flatten(1)], dim=-1) > 0)
        return torch.stack(out)
    nflat = act[4].shape[1]
    eye = torch.eye(nflat, device=dev)
    fc0 = torch.zeros(256, device=dev)

    def flat(conv2_act, conv2_crt):
        return torch.cat([trunk_cuda.twin_trunks(
            scans, (*act[:2], *conv2_act, eye[lo:lo + 256], fc0),
            (*crt[:2], *conv2_crt, eye[lo:lo + 256], fc0), precision)
            for lo in range(0, nflat, 256)], dim=-1) > 0

    return torch.cat([flat(act[2:4], crt[2:4]),
                      flat((taps(1), zero), (taps(1), zero)),
                      flat((taps(0), zero), (taps(0), zero))], dim=-1)


def branch_pieces(policy, feats, conv, mb, clip):
    """Per sample, the pieces of the piecewise PPO loss it takes with the
    (2, B, 256) trunk features ``feats`` and the conv ReLUs ``conv``
    (conv_pieces): by kind, (B, n) booleans of the conv and fc1 ReLUs of
    both trunks, the fc2 ReLUs of both heads and the ratio against the
    clip; for a bf16 policy also the value and mean, whose bf16 roundings
    are pieces too (BF16_FLIP_SHARE)."""
    from rl_collision_avoidance_torch.models import distributions

    dt = policy.dtype
    gs = torch.cat([mb.goal, mb.speed], dim=-1).to(dt)
    fc2 = torch.cat([
        policy.dense(torch.cat([feats[0].to(dt), gs], dim=-1), policy.act_fc2),
        policy.dense(torch.cat([feats[1].to(dt), gs], dim=-1),
                     policy.crt_fc2)], -1)
    value, mean, logstd = policy.heads(feats, mb.goal, mb.speed)
    ratio = torch.exp(distributions.log_normal_density(mb.action, mean,
                                                       logstd) - mb.logprob)
    rounded = ({} if dt == torch.float32
               else {"out": torch.cat([value, mean], dim=-1)})
    return {**rounded, "conv": torch.cat([conv[0], conv[1]], dim=-1),
            "fc1": torch.cat([feats[0] > 0, feats[1] > 0], dim=-1),
            "fc2": fc2 > 0,
            "clip": torch.cat([ratio < 1 - clip, ratio > 1 + clip], dim=-1)}


def float64_grads(policy, mb, cfg, plain):
    """By parameter name, (the float64 plain path's gradient of the PPO
    loss on ``mb``, its |terms| scale): elementwise the larger of that
    gradient's magnitude and of the gradient with each sample's cotangent
    at the policy's outputs (value, mean) made positive, so that no
    sample's term cancels another's (see GRAD_NORM)."""
    import copy

    from rl_collision_avoidance_torch.algo.ppo import Batch, ppo_loss

    model = copy.deepcopy(policy).double()
    params = list(model.parameters())
    mb = Batch(*(x.double() for x in mb))
    out = plain(model)(mb.scans, mb.goal, mb.speed)
    loss = ppo_loss(lambda *_: out, mb, cfg)[0]
    cot = torch.autograd.grad(loss, out[:2], retain_graph=True)
    exact = torch.autograd.grad(loss, params, retain_graph=True)
    same_sign = sum((c.abs() * o).sum() for c, o in zip(cot, out[:2]))
    flat = torch.autograd.grad(same_sign, params, allow_unused=True)
    return {n: (e, e.abs() if f is None else torch.maximum(e.abs(), f.abs()))
            for (n, _), e, f in zip(policy.named_parameters(), exact, flat)}


def compare_minibatch_grads(tr, state, traj, last_value, f64: bool) -> list:
    """The parameter gradients of GRAD_MINIBATCHES minibatches' PPO loss
    through the kernels (TwinTrunks) against autograd through the plain
    trunks, on the samples where both take the same pieces (see
    MAX_FLIP_SHARE); with ``f64``, a leaf that misses that rule against the
    float64 plain path (see float64_grads).  A bf16 policy's plain path is
    the plain bf16 trunks and the same bf16 tail.  Returns the samples of
    each minibatch that took other pieces."""
    from rl_collision_avoidance_torch.algo.ppo import Batch, ppo_loss
    from rl_collision_avoidance_torch.models.policy import PRECISION

    cfg, policy = tr.cfg.ppo, state.policy
    precision = PRECISION[policy.dtype]
    batch = tr._batch(traj, last_value)
    params = list(policy.parameters())
    act, crt = policy.trunk_weights("act"), policy.trunk_weights("crt")

    def plain(model):
        a, c = model.trunk_weights("act"), model.trunk_weights("crt")
        return lambda s, g, sp: model.heads(
            trunk_cuda.twin_trunks_plain(s, a, c, precision), g, sp)

    def grads(mb):
        with float32_sums():
            got = torch.autograd.grad(ppo_loss(policy, mb, cfg)[0], params)
            with trunk_cuda.exact_float32():
                want = torch.autograd.grad(
                    ppo_loss(plain(policy), mb, cfg)[0], params)
        return got, want

    rel = lambda a, b: float((a.double() - b.double()).norm()
                             / b.double().norm().clamp(min=1e-30))
    peak = lambda a, b: (float((a.double() - b.double()).abs().max())
                         / max(float(b.abs().max()), 1e-30))
    names = [n for n, _ in policy.named_parameters()]
    flipped_counts = []
    for trial in range(GRAD_MINIBATCHES):
        idx = torch.randperm(batch.scans.shape[0], generator=state.generator,
                             device=tr.device)[:cfg.batch_size]
        mb = Batch(*(x[idx] for x in batch))
        with torch.no_grad():
            feats_k = trunk_cuda.twin_trunks(mb.scans, act, crt, precision)
            conv_k = conv_pieces(mb.scans, act, crt, True, precision)
            with trunk_cuda.exact_float32():
                feats_p = trunk_cuda.twin_trunks_plain(mb.scans, act, crt,
                                                       precision)
                conv_p = conv_pieces(mb.scans, act, crt, False, precision)
                pk = branch_pieces(policy, feats_k, conv_k, mb,
                                   cfg.clip_value)
                pp = branch_pieces(policy, feats_p, conv_p, mb,
                                   cfg.clip_value)
            del conv_k, conv_p
        flipped = torch.stack([(pk[k] != pp[k]).any(dim=-1)
                               for k in pk]).any(dim=0)
        n_flip = int(flipped.sum())
        flipped_counts.append(n_flip)
        if n_flip > MAX_FLIP_SHARE * cfg.batch_size:
            raise AssertionError(f"minibatch {trial}: {n_flip} samples on "
                                 f"other pieces")
        kept = mb._replace(weight=mb.weight * ~flipped)
        got, want = grads(kept)
        exact = None
        for name, a, b in zip(names, got, want):
            el, nrm = peak(a, b), rel(a, b)
            if precision == "bf16" and not name.startswith(TRUNK_LEAVES):
                ulp = (a - b).abs() <= torch.clamp(BF16_ULP * b.abs(),
                                                   min=GRAD_ATOL
                                                   * float(b.abs().max()))
                if not (bool(ulp.all()) and nrm <= BF16_ULP):
                    raise AssertionError(f"minibatch {trial}: bf16 {name}: "
                                         f"{int((~ulp).sum())} elements "
                                         f"beyond one ulp, {nrm:.3g} norm")
                continue
            if el <= GRAD_ATOL and nrm <= GRAD_NORM:
                continue
            if not f64:
                raise AssertionError(f"minibatch {trial}: {name}: {el:.3g} "
                                     f"of max, {nrm:.3g} norm")
            if exact is None:
                exact = float64_grads(policy, kept, cfg, plain)
            c, sc = exact[name]
            el64 = (float((a.double() - c).abs().max())
                    / max(float(sc.max()), 1e-30))
            k64 = float((a.double() - c).norm() / sc.norm().clamp(min=1e-30))
            if not (el64 <= GRAD_ATOL and k64 <= GRAD_NORM):
                raise AssertionError(f"minibatch {trial}: {name}: {nrm:.3g} "
                                     f"norm; from float64 {k64:.3g} of the "
                                     f"|terms| scale, {el64:.3g} of max")
    return flipped_counts


#: The trunk kernels' functions by mode, as their mangled names spell them
#: (length-prefixed, so one is never read inside another): the bf16 mode's
#: products, conv pass and conv_bwd run on the tensor cores; the float32
#: mode's never do (the exact-f32 rule bans TF32 there).
TENSOR_CORE_KERNELS = ("mma_gemm_kernel", "conv_mma_kernel",
                       "conv_bwd_mma_kernel")
FLOAT32_KERNELS = ("gemm_kernel", "conv_fwd_kernel", "conv_bwd_kernel")


def read_sass(lib: Path) -> str:
    """``cuobjdump -sass`` of the built library ``lib``, from the toolkit
    beside nvcc; raises when it has no cuobjdump."""
    from rl_collision_avoidance_torch.ops import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.is_file():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool}): the "
                           f"tensor-core check needs it")
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def sass_mma_counts(sass: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each kernel function of a
    ``cuobjdump -sass`` listing."""
    counts, name = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    return counts


def check_sass(counts: dict) -> dict:
    """Every bf16 product, conv-pass and conv_bwd kernel of ``counts``
    (:func:`sass_mma_counts`) has HMMA/HGMMA instructions, no float32 kernel
    has any; returns the counts by kernel family."""
    out = {}
    for names, tensor in ((TENSOR_CORE_KERNELS, True),
                          (FLOAT32_KERNELS, False)):
        for n in names:
            fns = {f: c for f, c in counts.items() if f"{len(n)}{n}" in f}
            if not fns:
                raise AssertionError(f"no {n} in the built library")
            bad = [f for f, c in fns.items() if (c == 0) == tensor]
            if bad:
                raise AssertionError(
                    f"{n}: {'no' if tensor else 'some'} tensor-core "
                    f"instructions in {bad}")
            out[n] = sorted(fns.values())
    return out


def reset_counts():
    """Every kernel's launch counts and the graph counts to 0."""
    lidar_cuda.launches = trunk_cuda.launches = trunk_cuda.bwd_launches = 0
    env_cuda.launches = graphs.captures = graphs.replays = 0
    lidar_cuda.launches_by_mode.clear()
    trunk_cuda.launches_by_mode.clear()
    env_cuda.launches_by_mode.clear()


def read_counts() -> dict:
    """Launches since :func:`reset_counts` by (kernel, batch, precision):
    the lidar (``lidar_obs``, or ``lidar_obs_walls`` in its walls-only
    mode) and the env step (``env_physics``, and ``env_reset`` and the
    reset sampler ``env_sample`` where the world resets) run in float32 in
    every mode."""
    return {**lidar_cuda.launches_by_mode, **trunk_cuda.launches_by_mode,
            **env_cuda.launches_by_mode}


def env_launches(env, robots: int, steps: int) -> dict:
    """The env-step kernels' launches of ``steps`` steps of ``env`` at
    ``robots`` robots: none off the kernel path (the box footprint), the
    reset sampler and the reset apply only where the world resets."""
    if env._kernels is None:
        return {}
    out = {("env_physics", robots, "float32"): steps}
    if not env._kernels.fixed:
        out[("env_sample", robots, "float32")] = steps
        out[("env_reset", robots, "float32")] = steps
    return out


def training_launches(tr, updates: int, steps_per_update: int) -> dict:
    """The launches ``updates`` updates of a fresh trainer ``tr`` make (on
    its rank, in a process group): the rollout's horizon acting steps and
    its bootstrap at the rank's arena batch each, one forward and one
    backward for each of the rank's PPO minibatches.  The acting step runs
    from a CUDA graph, whose replays launch its forward; before its
    capture, its ``graphs.WARMUP`` warm-up runs launch it too."""
    from rl_collision_avoidance_torch.models.policy import PRECISION

    cfg, precision = tr.cfg, PRECISION[tr.cfg.policy_dtype]
    robots = tr.n_local * tr.spec.n_robots
    mb = cfg.ppo.batch_size // tr.world
    lidar = "lidar_obs_walls" if tr.env.walls_only else "lidar_obs"
    n = updates
    return {(lidar, robots, "float32"): n * cfg.horizon,
            ("twin_trunks", robots, precision):
                graphs.WARMUP + n * (cfg.horizon + 1),
            ("twin_trunks", mb, precision): n * steps_per_update,
            ("twin_trunks_grads", mb, precision): n * steps_per_update,
            **env_launches(tr.env, robots, n * cfg.horizon)}
