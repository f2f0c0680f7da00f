"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernels, holds each against its plain PyTorch version
on the card at every batch size and world the paths below give it, then
drives the curriculum through the port's entry points and checks that each
path ran through the kernels, at those batch sizes, and stayed right:

- stage-1 acting (policy forward -> Gaussian sample -> env step, 128 arenas
  x 24 robots, the committed trained weights);
- stage-1 training (rollout, GAE and clipped PPO with Adam, 32 arenas,
  warm-started from the same weights);
- the circle-50 eval (``run_circle_eval`` with the committed fine-tuned
  weights, up to 3,000 steps): the deterministic ring, and 32 arenas at
  0.1 m of pose noise, which must reach a success rate of 0.90;
- stage-2 training (16 arenas x 44 robots warm-started from the stage-1
  weights, one warm-up and two timed updates; goal share >= 0.20);
- the circle fine-tune (16 arenas x 50 robots from the fine-tuned weights,
  one update);
- a checkpoint round trip: a stage-2 update after a save and a restore into
  a fresh Trainer is bit-equal to the update without the break;
- the acting step's CUDA graphs (``utils/graphs.py``): two stage-1 rollouts
  at 768 robots, two stage-2 rollouts at 704 and the circle eval at 1,600
  replayed from their graphs, bit-equal to the same steps run eagerly, with
  the host microseconds a step both ways and the graph counts;
- in bf16 (``--bf16 --obs-bf16``: the trunk kernels' bf16 mode on the
  tensor cores, a bf16 policy tail, bf16 scans): stage-1 acting at 128
  arenas and stage-1 training at 32 arenas, with the bf16 trunk forward
  held to its plain bf16 version at B = 768, 3,072 and 32,768 and the bf16
  backward at 32,768;
- Stage's exact 0.44 x 0.38 m box footprint (rect collision and box lidar
  silhouettes; the lidar kernel's walls-only mode with the silhouettes in
  plain PyTorch): stage1_rect training at 32 arenas warm-started from the
  stage-1 weights (goal share >= 0.5, and one acting step against the plain
  path), and the rect circle eval with the fine-tuned weights: the ring
  (success 1.0, no collision), the ring culled to the 12 nearest robots
  (success 1.0) and 16 arenas at 0.3 m of pose noise (success >= 0.70);
  the device ms of the plain box silhouettes on each of these paths;
- multi-process training (``parallel/dist.py``, ``ppo_update`` over a
  process group):
  the stage-1 training slice again as one NCCL rank in-process, bit-equal
  to the one-process slice in its params and every metric; two gloo ranks
  sharing the card (NCCL refuses two ranks on one device), each a process
  of its own training 16 of the 32 arenas for 1 + 2 updates in float32 and
  in bf16 (params bit-equal across the ranks, goal share >= 0.5), with the
  lidar at 384 robots and the trunk kernels at 384 and 16,384 held to
  their plain versions; one ``ppo_update`` of a synthetic 32,768-sample
  minibatch split over the ranks against one process's update of the whole
  (the gradient Adam stepped on, the params after, the losses); and the
  time of one all-reduce of the flattened gradient on each backend.  The
  two-rank runs check correctness: two ranks on one card are no scaling
  figure;
- the world compiler (``worlds/compile.py``, its PNG reader
  ``worlds/png.py``): stage 1, stage 2 and the circle rink compiled from the
  port's bitmaps with no image library, bit-equal to the committed tables,
  and one env step on the compiled stage-1 world bit-equal to the step on
  the committed one;
- the curriculum entry point (``examples/train_curriculum.py``): stage 1
  at 32 arenas and stage 2 at 16 from the best stage-1 params, 2 updates
  each with a checkpoint after each, then the ring and 16 arenas at 1 m of
  pose noise for up to 300 steps: its files, finite metrics, and the three
  kernels launched at each stage's batches;
- ``MLPPolicy``: a forward and backward on the card against the CPU at
  3,072 observations of 1,540 inputs;
- stage-2 training in bf16 (``--bf16 --obs-bf16``, 16 arenas, a warm-up and
  one timed update, goal share >= 0.20), with the bf16 trunk kernels held
  to their plain versions at its batches, 704 and 8,192;
- the results pipeline (``examples/make_results.py``, through its
  ``main``): the circle fine-tune at 16 arenas with a jittered-circle
  selection eval (8 arenas at 0.3 m) after each of 2 updates, the kept
  params held to ``select_score``'s choice, then the sweep (the ring, 32
  arenas at 0.1, 0.3 and 1.0 m, the 12-robot ring, the stage-2 block), each
  eval cut to 300 steps; then the bf16 fine-tune (``--bf16``, with and
  without ``--obs-bf16``) cut the same way, its evals in float32; the bf16
  trunk kernels held at the fine-tune's batches, 800 and 10,240, on bf16
  and on float32 scans.

The env-step kernels (``ops/env_cuda.py``, every disc world's step on the
card) are held to the plain chain (``use_kernels=False``) over chained
steps at each world and batch of these paths: every field of the step
equal, bit for bit; each path's launches of them are counted like the
other kernels'.  On the training and eval paths the acting step's policy
forward is captured once (a fresh trainer, or a fresh policy in the eval)
and replayed: its kernel's launches there are the capture's
``graphs.WARMUP`` warm-up runs and one a replay, besides the bootstrap's;
the capture itself launches nothing.

Right after the build it reads the library's SASS (``cuobjdump -sass``):
every bf16 product, conv-pass and conv_bwd kernel must hold tensor-core
instructions (HMMA/HGMMA) and no float32 kernel may.  Each kernel's time is
its device time (torch.profiler's kernel durations over many calls), beside
the wrapper's host microseconds a call and, for the trunk kernels, the
bytes of the workspace tensor one launch allocated and the rise of the
allocator's peak over that call.  It also prints the device ms of each
pass of one trunk forward and one backward launch at B = 32,768 in each
mode (torch.profiler).  It writes nothing into the tree (the checkpoint goes to
a temporary directory).

    python3 chip_smoke.py

(``chip_smoke.py mp-rank RANK URL OUT DEVICE`` is one of the two gloo ranks;
the script starts them itself.)  Needs one CUDA card and the CUDA toolkit
(nvcc).  Exits non-zero, with no result line, when there is no card or
when the port is not beside it.  Its
last three lines are the JSON record of each kernel on each path, world,
batch size and precision (launches counted on that path, times measured at
that batch),
the card's name and power limit from nvidia-smi, and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PARAMS = ROOT / "results" / "stage1_params.npz"
CIRCLE_PARAMS = ROOT / "results" / "circle_ft_params.npz"
#: The weights each world's checks and paths use: stage 2 warm-starts from
#: stage 1, the circle eval and the fine-tune use the fine-tuned policy.
WORLD_PARAMS = {"stage1": PARAMS, "stage2": PARAMS, "circle": CIRCLE_PARAMS,
                "circle_train": CIRCLE_PARAMS, "stage1_rect": PARAMS,
                "circle_12": CIRCLE_PARAMS}
ARENAS = 128          # the JAX bench's accelerator default: 3,072 robots
SLICE_STEPS = 256     # timed acting steps (after WARMUP_STEPS)
WARMUP_STEPS = 8
SEED = 0
LIDAR_ATOL = 1e-5     # normalized obs, as tests/test_pallas.py holds the TPU kernel
ENV_STEPS = 40        # chained steps of the env-step kernels held to the plain chain
# The trunk kernel sums its 4096-long fc1 dot products (and the 96- and
# 15-long conv sums) in another order than cuBLAS/cuDNN; the rounding error
# of such a sum is ~sqrt(n) * 2^-24 * sum|terms| ~ 1e-5 at these weights, so
# 1e-4 absolute plus 1e-4 relative leaves room without hiding a wrong
# weight, tap or layout (those give errors of order 1).
TRUNK_ATOL = TRUNK_RTOL = 1e-4
POLICY_ATOL = 1e-4    # actions and values through the trunk features
TRAIN_ARENAS = 32     # the stage-1 preset of the committed training curve
TRAIN_UPDATES = 2     # timed updates, after one warm-up update
BWD_BATCH = 32768     # one stage-1 minibatch at 32 arenas (1024 x 32)
EVAL_STEPS = 3000     # the circle eval's step limit (results/circle_eval.json)
EVAL_ARENAS = 32      # the committed 0.1 m robustness study
EVAL_NOISE = 0.1
EVAL_MIN_SUCCESS = 0.90   # the committed TPU value is 0.994375
S2_ARENAS = 16        # the stage-2 phase of results/META.json
S2_MIN_GOAL = 0.20    # results/stage2_metrics.csv reads 0.43, 0.58 at updates 1-2
FT_ARENAS = 16        # the circle_ft phase of results/META.json
GRAPH_EVAL_STEPS = 300   # steps of each eval call graphed against eager
# The rect footprint's committed TPU outcomes (results/circle_eval_rect.json):
# the ring at success 1.0 with 0 collisions, culled to the 12 nearest at
# 1.0, and 16 arenas at 0.3 m at a success mean of 0.835 with a std of
# 0.195 over the arenas, a standard error of ~0.049: 0.70 lies about three
# of them below.
RECT_CULL_K = 12
RECT_ARENAS = 16
RECT_NOISE = 0.3
RECT_MIN_SUCCESS = 0.70
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
# Multi-process training on the one card: two gloo ranks (NCCL refuses two
# ranks on one device) with TRAIN_ARENAS / MP_RANKS arenas and half of each
# global minibatch each, as a two-card run cuts the stage-1 preset.  Each
# rank is a process of its own (this script with the arguments ``mp-rank
# RANK URL OUT DEVICE``) and must finish within MP_TIMEOUT seconds.
MP_RANKS = 2
MP_TIMEOUT = 420
MP_MIN_GOAL = 0.5     # the stage-1 gate of the one-process training slice
# The curriculum entry point (examples/train_curriculum.py) at the presets'
# full width (stage 1 at TRAIN_ARENAS, stage 2 at S2_ARENAS, the ring and
# CURRICULUM_EVAL_ARENAS jittered arenas) and cut in depth: from random
# init, CURRICULUM_UPDATES updates a stage with a checkpoint after each, and
# an eval of up to CURRICULUM_EVAL_STEPS steps.  Its three paths take the
# batches the stage-1, stage-2 and circle-eval checks above hold.
CURRICULUM_UPDATES = 2
CURRICULUM_EVAL_ARENAS = 16
CURRICULUM_EVAL_STEPS = 300
# The results pipeline (examples/make_results.py) through its main, at the
# fine-tune's full width (FT_ARENAS arenas x 50 robots; the selection eval
# over make_results.SELECT_ARENAS arenas at SELECT_NOISE; the sweep over
# EVAL_ARENAS arenas, the ring and the 12-robot ring), cut in depth:
# PIPELINE_UPDATES updates with a selection eval after each (in place of
# 2,000 and every 50), and PIPELINE_EVAL_STEPS steps in every eval (in place
# of 3,000).  It warm-starts from the fine-tuned weights, which stand in for
# stage2_params.npz (left out of the export), in float32 and in bf16 (with
# and without bf16 scans).  Stage 2 trains in bf16 for S2_BF16_UPDATES
# updates (the first a warm-up) with the float32 phase's goal-share gate.
PIPELINE_UPDATES = 2
PIPELINE_EVAL_STEPS = 300
S2_BF16_UPDATES = 2
# MLPPolicy on the card against the CPU: a forward and the gradient of a
# mean loss over MLP_BATCH observations of MLP_OBS inputs (3 x 512 scan
# beams, goal and speed), exact float32 (no TF32) on both.
MLP_BATCH = 3072
MLP_OBS = 1540
MLP_ATOL = 1e-5
MB_SEED = SEED + 5    # the synthetic minibatch of the split-gradient check
# Published H100 SXM peaks (NVIDIA data sheet): HBM, non-tensor float32 and
# dense bf16 tensor-core products.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


def phase(name):
    """Decorator: print the phase's name and seconds; any failure raises."""
    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            print(f"[{name}] ok in {time.perf_counter() - t0:.2f} s",
                  flush=True)
            return out
        return run
    return wrap


def spec_of(world: str):
    """The WorldSpec of a world name of WORLD_PARAMS: ``circle_12`` is the
    circle with 12 robots on its 25 m ring (the sweep's ``ring_12_robots``
    row), any other name ``get_world``'s."""
    from rl_collision_avoidance_torch.worlds import circle, get_world

    return circle(n_robots=12) if world == "circle_12" else get_world(world)


def time_ms(fn, iters: int, warmup: int = 3) -> tuple[float, float]:
    """(device ms, host us) per call of ``fn``.  Device ms: the summed
    durations of the device's kernels and copies over ``iters`` calls, from
    torch.profiler, over ``iters``; the work alone, not the host's enqueue
    around it, which for a kernel shorter than its wrapper is what CUDA
    events around back-to-back calls measure.  Host us: the wall time of
    ``iters`` calls without a synchronize, over ``iters``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA)
    if us > 0:
        return us / iters / 1e3, host_us
    # the profiler now and then records no device event at all: CUDA events
    # around the back-to-back calls instead (the host's enqueue included)
    ms = timed(lambda: [fn() for _ in range(iters)],
               torch.device("cuda", torch.cuda.current_device()))[1]
    print(f"time: torch.profiler recorded no device time; CUDA events read "
          f"{ms / iters:.4g} ms a call", flush=True)
    return ms / iters, host_us


@contextlib.contextmanager
def float32_sums():
    """bf16 products on the card with float32 sums throughout (no bf16
    split-K reduction in cuBLAS), restoring the setting on exit."""
    import torch

    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            prev)


def timed(fn, device):
    """(fn(), device ms from CUDA events); the time is None off the card."""
    import torch

    if device.type != "cuda":
        return fn(), None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time in ms for moving ``nbytes`` and doing ``ops`` operations
    at ``ops_per_s`` (float32 by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def trunk_ops(frames: int, beams: int) -> tuple[int, int]:
    """Float32 operations (FMA = 2) of one sample through one trunk: the
    forward, and the backward with its recomputed forward."""
    l1 = (beams - 3) // 2 + 1
    l2 = (l1 - 1) // 2 + 1
    taps1 = sum(1 for l in range(l1) for k in range(5)
                if 0 <= 2 * l + k - 1 < beams)
    taps2 = sum(1 for m in range(l2) for k in range(3)
                if 0 <= 2 * m + k - 1 < l1)
    conv1, conv2, fc1 = 2 * 32 * frames * taps1, 2 * 32 * 32 * taps2, \
        2 * 256 * 32 * l2
    fwd = conv1 + conv2 + fc1 + 2 * 32 * (l1 + l2) + 2 * 256
    # dWf and dflat (fc1-sized each), dW2 and the transposed conv2
    # (conv2-sized each), dW1 (conv1-sized), the ReLU masks and bias sums
    bwd = fwd + 2 * fc1 + 2 * conv2 + conv1 + 2 * (256 + 32 * (l1 + l2))
    return fwd, bwd


@phase("device")
def check_device():
    import torch

    from rl_collision_avoidance_torch.utils.device import card_label

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; none is visible")
    name = torch.cuda.get_device_name(0)
    label = card_label()
    print(f"device: {name} | nvidia-smi: {label} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    return name, label


@phase("build")
def build_kernels():
    from rl_collision_avoidance_torch.ops import build

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"build: {lib.relative_to(ROOT)} ready in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


#: The trunk kernels' functions by mode, as their mangled names spell them
#: (length-prefixed, so one is never read inside another): the bf16 mode's
#: products, conv pass and conv_bwd run on the tensor cores; the float32
#: mode's never do (the exact-f32 rule bans TF32 there).
TENSOR_CORE_KERNELS = ("mma_gemm_kernel", "conv_mma_kernel",
                       "conv_bwd_mma_kernel")
FLOAT32_KERNELS = ("gemm_kernel", "conv_fwd_kernel", "conv_bwd_kernel")


def sass_mma_counts(lib) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each kernel function of the
    built library, from ``cuobjdump -sass``; raises when the toolkit has no
    cuobjdump."""
    from rl_collision_avoidance_torch.ops import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.is_file():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool}): the "
                           f"tensor-core check needs it")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    return counts


@phase("tensor-core SASS")
def check_sass() -> dict:
    """Every bf16 product, conv-pass and conv_bwd kernel has HMMA/HGMMA
    instructions, no float32 kernel has any; returns the counts by kernel
    family and mode."""
    from rl_collision_avoidance_torch.ops import build

    counts = sass_mma_counts(build.build())
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
    print(f"sass: HMMA/HGMMA instructions per kernel instance (cuobjdump "
          f"-sass): {json.dumps(out)}", flush=True)
    return out


def stage1_test_poses(env, arenas: int):
    """Seeded poses for every robot: uniform in the spawn disc, plus per
    arena one robot 0.3-0.5 m from the east wall facing it and a pair of
    robots 0.5-0.7 m apart, so walls and discs are hit at short range."""
    import math

    import torch

    pose, _ = env.sample_pose_goal(arenas)
    g = env.generator
    dev = env.device
    u = torch.rand((arenas, 4), generator=g, device=dev)
    pose[:, 0, 0] = 9.6 - 0.3 - 0.2 * u[:, 0]          # wall at x = 9.6
    pose[:, 0, 1] = 2.0 * u[:, 1] - 1.0
    pose[:, 0, 2] = 0.5 * u[:, 2] - 0.25
    gap = 0.5 + 0.2 * u[:, 3]
    ang = 2 * math.pi * u[:, 2]
    pose[:, 2, 0] = pose[:, 1, 0] + gap * torch.cos(ang)
    pose[:, 2, 1] = pose[:, 1, 1] + gap * torch.sin(ang)
    return pose.contiguous()


def test_poses(env, arenas: int):
    """Seeded poses of ``arenas`` arenas of the env's world for the lidar
    check.  Stage 1: see :func:`stage1_test_poses`.  Otherwise the world's
    reset poses (stage 2: tables and corridor draws; circle: the ring at
    step 0), in the circle worlds' further arenas drawn in towards the
    centre down to 4 m with random headings (robots that finished spin in
    place), and with more than one arena the last one the culling rules'
    edge cases (lidar_cuda.adversarial_poses)."""
    import math

    import torch

    from rl_collision_avoidance_torch.ops import lidar_cuda

    spec = env.spec
    if spec.name.startswith("stage1"):
        pose = stage1_test_poses(env, arenas)
    else:
        pose = env.sample_pose_goal(arenas)[0]
    if spec.name.startswith("circle") and arenas > 1:
        scale = torch.linspace(1.0, 0.16, arenas, device=env.device)
        pose[..., :2] *= scale[:, None, None]
        pose[1:, :, 2] = 2 * math.pi * torch.rand(
            pose[1:, :, 2].shape, generator=env.generator, device=env.device)
    if arenas > 1:
        pose[-1] = torch.from_numpy(lidar_cuda.adversarial_poses(
            spec, spec.n_robots, seed=SEED))[0].to(env.device)
    return pose.contiguous()


@phase("lidar kernel vs plain")
def check_lidar(device, world: str, arenas: int, discs: bool = True):
    """The lidar kernel against its plain version on the world's test
    poses; with ``discs=False`` its walls-only mode (record
    ``lidar_obs_walls``), whose reference work is the walls part alone."""
    import torch

    from rl_collision_avoidance_torch.engine.celltable import lookup_cells
    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.ops import lidar_cuda

    spec = spec_of(world)
    env = Env(spec, device=device, seed=SEED)
    t = env.lidar_table
    pose = test_poses(env, arenas)
    args = (env._lidar_cells, t.lo, t.cell, t.shape, env.local_dirs,
            spec.robot_radius, spec.max_range)
    got = lidar_cuda.lidar_obs(pose, *args, discs=discs)
    want = lidar_cuda.lidar_obs_plain(pose, *args, discs=discs)
    err = float((got - want).abs().max())
    if device.type == "cuda":
        torch.cuda.synchronize()  # a fault inside the kernel surfaces here
    if not (err <= LIDAR_ATOL and torch.isfinite(got).all()):
        raise AssertionError(f"lidar kernel differs from its plain version "
                             f"by {err} > {LIDAR_ATOL}")
    equal = float((got == want).double().mean())
    err_adv = float((got[-1] - want[-1]).abs().max())
    short = float((got < 0.5 / spec.max_range - 0.5).any(-1).float().mean())
    name = "lidar_obs" if discs else "lidar_obs_walls"
    print(f"lidar: {name} {world} K = {t.k}: max |kernel - plain| = {err:.3g} on "
          f"{tuple(got.shape)} (atol {LIDAR_ATOL}; {err_adv:.3g} on the last "
          f"arena), share of outputs bit-equal to plain {equal:.6f}; share "
          f"of robots with a beam under 0.5 m: {short:.2f}", flush=True)

    a, n, beams = got.shape
    cells = lookup_cells(t.lo, t.cell, t.shape, pose[..., :2])
    cand = int(torch.as_tensor(t.counts, device=device)[cells].sum())
    # The reference function's work, as in earlier records: per (robot,
    # beam) rotation 6, final min + normalize 4; per valid candidate segment
    # 12; per other robot's disc 11 (none in the walls-only mode).  The
    # kernel skips more (csrc/lidar.cu: no division where the window fails,
    # no far or enclosing disc), so this count is an upper bound of what it
    # does.
    per_disc = 11 * (n - 1) if discs else 0
    ops = beams * (a * n * (6 + 4 + per_disc) + 12 * cand)
    nbytes = 4 * (pose.numel() + t.table.size + env.local_dirs.numel()
                  + got.numel())
    record = {"name": name, "route": "cuda",
              "source": "rl_collision_avoidance_torch/ops/csrc/lidar.cu",
              "replaces": "rl_collision_avoidance_tpu/ops/lidar_pallas.py:35",
              "world": world, "batch": a * n, "precision": "float32",
              "max_abs_err": err, "library_ms": None,
              "workspace_bytes": None, "peak_bytes": None}
    if device.type == "cuda":
        record["ms"], record["host_us"] = time_ms(
            lambda: lidar_cuda.lidar_obs(pose, *args, discs=discs), 50)
        record["plain_ms"] = time_ms(
            lambda: lidar_cuda.lidar_obs_plain(pose, *args, discs=discs),
            10)[0]
    record["bound_ms"], record["bound_by"] = bound(nbytes, ops)
    return record


@phase("env-step kernels vs plain")
def check_env(device, world: str, arenas: int) -> list:
    """The env-step kernels (``ops/env_cuda.py``) against the plain chain
    (``use_kernels=False``) over ENV_STEPS chained steps from the world's
    test poses, each path on its own states, with actions out of their
    bounds and the same reset draws: every bool, int and float field of
    the step equal, the scans within LIDAR_ATOL.  Returns the records of
    ``env_physics`` and, where the world resets, ``env_reset``: each
    kernel's device ms and its wrapper's host us, and as ``plain_ms`` the
    plain chain's device ms a step without the lidar.  Prints both paths'
    device ms and host us a step without the lidar."""
    import dataclasses

    import torch

    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.ops import env_cuda

    spec = spec_of(world)
    env = Env(spec, device=device, seed=SEED)
    plain = Env(spec, device=device, seed=SEED, use_kernels=False)
    n, robots = spec.n_robots, arenas * spec.n_robots
    pose = test_poses(env, arenas)
    goal = env.sample_pose_goal(arenas)[1]
    state, pstate = (e.reset(arenas, pose, goal)[0] for e in (env, plain))
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    fields = lambda out: {
        **vars(out[0]), "obs.goal": out[1].goal, "reward": out[2],
        "done": out[3], **{f"info.{k}": v for k, v in vars(out[4]).items()}}
    differ, err, resets = 0, 0.0, 0
    for _ in range(ENV_STEPS):
        act = torch.rand((arenas, n, 2), generator=gen, device=device) * 4 \
            - 1.5
        draw = env.sample_pose_goal(arenas, state.pose)
        got, want = (fields(e.step(s, act, *draw))
                     for e, s in ((env, state), (plain, pstate)))
        for k, w in want.items():
            if k == "scan_hist":
                err = max(err, float((got[k].float() - w.float()).abs().max()))
            else:
                differ += int((got[k] != w).sum())
        state = dataclasses.replace(state, **{k: got[k] for k in vars(state)})
        pstate = dataclasses.replace(pstate,
                                     **{k: want[k] for k in vars(pstate)})
        resets += int((state.step == 0).sum())
    if device.type == "cuda":
        torch.cuda.synchronize()  # a fault inside a kernel surfaces here
    if differ or not err <= LIDAR_ATOL:
        raise AssertionError(f"env step {world} {robots}: the kernel path "
                             f"left the plain chain in {differ} elements, "
                             f"scans by {err}")
    fixed = env._kernels.fixed
    base = {"route": "cuda",
            "source": "rl_collision_avoidance_torch/ops/csrc/env_step.cu",
            "replaces": "none: engine/env.py::Env._step_plain (the JAX "
                        "step is plain XLA)",
            "world": world, "batch": robots, "precision": "float32",
            "max_abs_err": 0.0, "library_ms": None, "workspace_bytes": None,
            "peak_bytes": None}
    k = env.wall_table.k
    # Bytes: the state, actions and wall-table rows read, the outputs
    # written; operations: integration, k segment and n - 1 disc tests
    # (~17 and ~6 a test), reward and masks ~40; the reset apply ~30 a
    # robot.  Both bounds lie far under the launch latency.
    records = [dict(base, name="env_physics", bound=bound(
        robots * (41 + 16 * k + (70 if fixed else 82)),
        robots * (12 * spec.substeps + 17 * k + 6 * (n - 1) + 40)))]
    if not fixed:
        records.append(dict(base, name="env_reset", bound=bound(
            robots * 70, robots * 30)))
    if device.type == "cuda":
        w = env._kernels
        draw = env.sample_pose_goal(arenas, state.pose)
        out = env_cuda.physics(w, state, act)
        records[0]["ms"], records[0]["host_us"] = time_ms(
            lambda: env_cuda.physics(w, state, act), 50)
        if not fixed:
            records[1]["ms"], records[1]["host_us"] = time_ms(
                lambda: env_cuda.reset_apply(w, out, *draw), 50)
        scan = env.scan_obs(state.pose)
        for e in (env, plain):     # the step without its lidar
            e.scan_obs = lambda pose: scan
        k_ms, k_us = time_ms(lambda: env.step(state, act, *draw), 50)
        p_ms, p_us = time_ms(lambda: plain.step(pstate, act, *draw), 20)
        for r in records:
            r["plain_ms"] = p_ms
        print(f"env step {world} {robots}: a step without the lidar: kernel "
              f"path {k_ms:.4g} device ms, {k_us:.1f} host us; plain chain "
              f"{p_ms:.4g} device ms, {p_us:.1f} host us", flush=True)
    for r in records:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
    print(f"env step {world} {robots}: the kernel path equal to the plain "
          f"chain in every field over {ENV_STEPS} steps ({resets} resets; "
          f"scans within {err:.3g}); kernels "
          f"{[(r['name'], r.get('ms'), r.get('host_us')) for r in records]}",
          flush=True)
    return records


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
    import torch

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


@phase("trunk kernel vs plain")
def check_trunk(device, world: str, batch: int, precision: str = "float32",
                f32_scans: bool = False):
    """The forward kernel against its plain version on the world's scans at
    ``batch``; in bf16 mode on bf16 scans, as ``--obs-bf16`` stores them,
    and with ``f32_scans`` also on float32 scans, as ``--bf16`` alone gives
    them to the bf16 kernels (held, not timed)."""
    import torch
    import torch.nn.functional as F

    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.models import load_policy
    from rl_collision_avoidance_torch.ops import trunk_cuda

    spec = spec_of(world)
    dtype = trunk_cuda.PRECISIONS[precision]
    policy = load_policy(WORLD_PARAMS[world], device=device)
    act, crt = policy.trunk_weights("act"), policy.trunk_weights("crt")

    def hold(obs_dtype):
        env = Env(spec, device=device, seed=SEED + 1, obs_dtype=obs_dtype)
        _, obs = env.reset(-(-batch // spec.n_robots))
        scans = obs.scans.reshape(-1, spec.laser_frames,
                                  spec.n_beams)[:batch].contiguous()
        with torch.no_grad():
            got = trunk_cuda.twin_trunks(scans, act, crt, precision)
            want = trunk_cuda.twin_trunks_plain(scans, act, crt, precision)
        err = float((got.float() - want.float()).abs().max())
        if device.type == "cuda":
            torch.cuda.synchronize()
        flips = check_features(got, want, precision,
                               f"trunk kernel ({precision}, {scans.dtype} "
                               f"scans)")
        print(f"trunk: {world} scans ({scans.dtype}), {precision}: max "
              f"|kernel - plain| = {err:.3g} on B = {scans.shape[0]} "
              f"({trunk_cuda.plan_for(scans, precision)}), features up to "
              f"{float(want.float().abs().max()):.3g}; bf16 rounding flips "
              f"{flips} of {got.numel()}", flush=True)
        return scans, got, err

    scans, got, err = hold(dtype)
    if f32_scans:
        hold(torch.float32)
    b, frames, beams = scans.shape

    per_sample, _ = trunk_ops(frames, beams)
    ops = 2 * b * per_sample              # two trunks; FMA = 2 ops
    nbytes = (scans.numel() * scans.element_size()
              + 4 * sum(w.numel() for w in (*act, *crt))
              + got.numel() * got.element_size())
    record = {"name": "twin_trunks", "route": "cuda",
              "source": "rl_collision_avoidance_torch/ops/csrc/trunk_fwd.cu",
              "replaces": "rl_collision_avoidance_tpu/ops/trunk_pallas.py:147",
              "world": world, "batch": b, "precision": precision,
              "max_abs_err": err}
    lib_w = [[w.to(dtype) for w in ws] for ws in (act, crt)]
    lib_x = scans.to(dtype)

    def library():  # the bare cuDNN / cuBLAS calls: exact float32, or bf16
        with trunk_cuda.exact_float32():
            for w1, b1, w2, b2, wf, bf in lib_w:
                y = F.relu(F.conv1d(lib_x, w1, b1, stride=2, padding=1))
                y = F.relu(F.conv1d(y, w2, b2, stride=2, padding=1))
                F.relu(F.linear(y.flatten(1), wf, bf))

    if device.type == "cuda":
        with torch.no_grad():
            record["ms"], record["host_us"] = time_ms(
                lambda: trunk_cuda.twin_trunks(scans, act, crt, precision), 20)
            record.update(call_memory(
                lambda: trunk_cuda.twin_trunks(scans, act, crt, precision),
                ("twin_trunks", b, precision), "trunk forward"))
            record["plain_ms"] = time_ms(
                lambda: trunk_cuda.twin_trunks_plain(scans, act, crt,
                                                     precision), 20)[0]
            record["library_ms"] = time_ms(library, 20)[0]
    record["bound_ms"], record["bound_by"] = bound(
        nbytes, ops, BF16_OPS_PER_S if precision == "bf16" else F32_OPS_PER_S)
    return record


def call_memory(fn, key, what: str) -> dict:
    """Device memory of one call of a trunk wrapper ``fn``, measured on the
    card: ``workspace_bytes``, the size of the workspace tensor that its
    launch allocated (``trunk_cuda.workspace_bytes[key]``), and
    ``peak_bytes``, the rise of the caching allocator's peak above what was
    allocated before the call (workspace and outputs), which must hold the
    workspace."""
    import torch

    from rl_collision_avoidance_torch.ops import trunk_cuda

    trunk_cuda.workspace_bytes.pop(key, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    out = {"workspace_bytes": trunk_cuda.workspace_bytes.get(key),
           "peak_bytes": torch.cuda.max_memory_allocated() - before}
    if out["workspace_bytes"] is None:
        raise AssertionError(f"{what}: the call launched no kernel at {key}")
    if out["peak_bytes"] < out["workspace_bytes"]:
        raise AssertionError(f"{what}: the allocator's peak rose by "
                             f"{out['peak_bytes']} bytes, less than the "
                             f"{out['workspace_bytes']}-byte workspace")
    print(f"{what} {key}: workspace {out['workspace_bytes']} bytes, the "
          f"call's peak rise {out['peak_bytes']} bytes", flush=True)
    return out


def reset_counts():
    """Every kernel's launch counts and the graph counts to 0."""
    from rl_collision_avoidance_torch.ops import (env_cuda, lidar_cuda,
                                                  trunk_cuda)
    from rl_collision_avoidance_torch.utils import graphs

    lidar_cuda.launches = trunk_cuda.launches = trunk_cuda.bwd_launches = 0
    env_cuda.launches = graphs.captures = graphs.replays = 0
    lidar_cuda.launches_by_mode.clear()
    trunk_cuda.launches_by_mode.clear()
    env_cuda.launches_by_mode.clear()


def read_counts() -> dict:
    """Launches since :func:`reset_counts` by (kernel, batch, precision):
    the lidar (``lidar_obs``, or ``lidar_obs_walls`` in its walls-only
    mode) and the env step (``env_physics``, and ``env_reset`` where the
    world resets) run in float32 in every mode."""
    from rl_collision_avoidance_torch.ops import (env_cuda, lidar_cuda,
                                                  trunk_cuda)

    return {**lidar_cuda.launches_by_mode, **trunk_cuda.launches_by_mode,
            **env_cuda.launches_by_mode}


def env_launches(env, robots: int, steps: int) -> dict:
    """The env-step kernels' launches of ``steps`` steps of ``env`` at
    ``robots`` robots: none off the kernel path (the box footprint), the
    reset apply only where the world resets."""
    if env._kernels is None:
        return {}
    out = {("env_physics", robots, "float32"): steps}
    if not env._kernels.fixed:
        out[("env_reset", robots, "float32")] = steps
    return out


@phase("stage-1 acting slice")
def run_slice(device, card: str, bf16: bool = False):
    """Stage-1 acting through ``bench.run_acting``; ``bf16``: the policy
    and the scan history in bf16 (``bench --bf16 --obs-bf16``)."""
    import torch

    from rl_collision_avoidance_torch import bench
    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.models import load_policy
    from rl_collision_avoidance_torch.worlds import stage1

    spec = stage1()
    dtype = torch.bfloat16 if bf16 else torch.float32
    precision = "bf16" if bf16 else "float32"
    policy = load_policy(PARAMS, device=device, dtype=dtype)
    env = Env(spec, device=device, seed=SEED, obs_dtype=dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)

    reset_counts()
    state, obs = env.reset(ARENAS)
    state, obs, warm = bench.run_acting(env, policy, state, obs, WARMUP_STEPS,
                                        gen)
    on_card = device.type == "cuda"
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    state, obs, stats = bench.run_acting(env, policy, state, obs, SLICE_STEPS,
                                         gen)
    if on_card:
        end.record()
        torch.cuda.synchronize()
    robots = ARENAS * spec.n_robots
    launches = read_counts()

    ends = (warm["ends"] + stats["ends"]).tolist()
    goal, crash, timeout = ends[1:]
    finite = bool(warm["finite"] & stats["finite"])
    print(f"slice ({precision}, scans {obs.scans.dtype}): {WARMUP_STEPS} + "
          f"{SLICE_STEPS} steps of {ARENAS} arenas x {spec.n_robots} robots; "
          f"episode ends goal {goal} crash {crash} timeout {timeout}; kernel "
          f"launches (name, batch, precision): {launches}", flush=True)
    if on_card:
        seconds = start.elapsed_time(end) / 1e3
        print(f"slice ({precision}): {robots * SLICE_STEPS / seconds:.1f} "
              f"robot-steps/s ({seconds * 1e3 / SLICE_STEPS:.3f} ms/step, "
              f"CUDA events) on {torch.cuda.get_device_name(device)} "
              f"[{card}]", flush=True)
    if not finite:
        raise AssertionError("non-finite reward or observation in the slice")
    if on_card and not (launches.get(("lidar_obs", robots, "float32"))
                        and set(launches) == {
                            ("lidar_obs", robots, "float32"),
                            ("twin_trunks", robots, precision),
                            *env_launches(env, robots, 1)}):
        raise AssertionError(f"a kernel of the path never ran, or ran at "
                             f"another batch: {launches}")
    ended = goal + crash + timeout
    if ended == 0 or goal / ended < 0.5:
        raise AssertionError(f"the trained stage-1 policy reached the goal in "
                             f"{goal} of {ended} episodes (< 50%)")
    print(f"slice ({precision}): goal share {goal / ended:.3f} of {ended} "
          f"ended episodes (the JAX training run's stage-1 plateau is ~0.85)",
          flush=True)
    compare_plain_step(env, policy, state, obs)
    return launches


def compare_plain_step(env, policy, state, obs):
    """One more step of the slice's state through the plain path (plain trunk
    + the env with use_kernels=False) against the kernel path, with the same
    noise and reset draws.  Both envs step with the kernel path's action, so
    the lidar comparison sees identical poses.  In bf16 the actions follow
    the bf16 rule of BF16_FLIP_SHARE (a pre-activation or a mean one ulp
    apart), and the bf16 scans may round a lidar range within LIDAR_ATOL
    one ulp apart."""
    import torch

    from rl_collision_avoidance_torch import bench
    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.models.policy import PRECISION
    from rl_collision_avoidance_torch.ops.trunk_cuda import twin_trunks_plain

    precision = PRECISION[policy.dtype]
    plain_env = Env(env.spec, device=env.device, use_kernels=False,
                    obs_dtype=env.obs_dtype, disc_cull_k=env.disc_cull_k,
                    rect_silhouette=env.rect_silhouette)
    a, n = obs.scans.shape[:2]
    noise = torch.randn((a * n, 2), generator=env.generator,
                        device=env.device)
    rp, rg = env.sample_pose_goal(a)
    action, s_k, o_k, r_k, d_k, _ = bench.act_step(env, policy, state, obs,
                                                   noise, None, rp, rg)
    with torch.no_grad():
        feats = twin_trunks_plain(obs.scans.reshape(a * n, *obs.scans.shape[2:]),
                                  policy.trunk_weights("act"),
                                  policy.trunk_weights("crt"), precision)
        _, mean, logstd = policy.heads(feats, obs.goal.reshape(a * n, 2),
                                       obs.speed.reshape(a * n, 2))
        plain_action = (mean + torch.exp(logstd) * noise).reshape(a, n, 2)
    s_p, o_p, r_p, d_p, _ = plain_env.step(state, action, rp, rg)
    d_act = (action - plain_action).abs()
    d_scan = (o_k.scans.float() - o_p.scans.float()).abs()
    errs = {"action": float(d_act.max()),
            "reward": float((r_k - r_p).abs().max()),
            "scans": float(d_scan.max()),
            "pose": float((s_k.pose - s_p.pose).abs().max())}
    flips = 0
    if precision == "bf16":
        # mean = (sigmoid(x0), tanh(x1)), x = w . h + b over the 128 bf16
        # activations h of act_fc2: a rounding of h or of x that falls the
        # other way moves x by at most one ulp of its terms' sum S =
        # |w| . |h| + |b|, so mean by the slope (at most 1/4, 1) times
        # BF16_ULP S, plus one ulp of mean for its own rounding
        with torch.no_grad():
            dt = policy.dtype
            gs = torch.cat([obs.goal, obs.speed], -1).reshape(a * n, 4)
            h = torch.relu(policy.dense(torch.cat([feats[0].to(dt),
                                                   gs.to(dt)], -1),
                                        policy.act_fc2)).double().abs()
            terms = torch.cat([
                h @ head.weight.double().abs().T + head.bias.double().abs()
                for head in (policy.actor1, policy.actor2)], -1)
        slope = torch.tensor([0.25, 1.0], device=terms.device,
                             dtype=torch.float64)
        m = mean.reshape(a, n, 2).double()
        flips = flip_check(d_act, POLICY_ATOL, POLICY_ATOL + BF16_ULP
                           * (m.abs() + slope * terms.reshape(a, n, 2)),
                           "bf16 actions")
        scans_ok = bool((d_scan <= LIDAR_ATOL + BF16_ULP
                         * o_p.scans.float().abs()).all())
    else:
        scans_ok = errs["scans"] <= LIDAR_ATOL
    print(f"plain-path step ({precision}): max |kernel path - plain path| "
          f"{errs}; actions beyond {POLICY_ATOL}: {flips}; done agrees: "
          f"{bool((d_k == d_p).all())}", flush=True)
    if not ((errs["action"] <= POLICY_ATOL or precision == "bf16")
            and errs["reward"] == 0.0 and errs["pose"] == 0.0 and scans_ok
            and bool((d_k == d_p).all())):
        raise AssertionError(f"the kernel path left the plain path: {errs}")


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
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv1d_input, conv1d_weight

    from rl_collision_avoidance_torch.ops.trunk_cuda import round_bf16

    rnd = round_bf16 if precision == "bf16" else (lambda v: v)
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
        print(f"trunk backward: trunk {t}: pre-activations within {BWD_TOL} "
              f"of their |terms| sum: fc1 {int(near3.sum())} of "
              f"{near3.numel()}, conv2 {int(near2.sum())} of "
              f"{near2.numel()}, conv1 {int(near1.sum())} of "
              f"{near1.numel()}", flush=True)
    return out


def check_grads(got, want, limits, precision: str, what: str,
                gate: bool = True) -> int:
    """Gradients (12 leaves, actor then critic) against the float64 plain
    version ``want``, with ``limits`` from :func:`trunk_grads_limits`: each
    element within BWD_TOL of its |terms| sum plus its near-ReLU terms; in
    bf16 by :func:`flip_check`, beyond that within BF16_ULP of the sum.
    Returns the elements beyond the float32 rule; raises only with
    ``gate``."""
    import torch

    from rl_collision_avoidance_torch.ops import trunk_cuda

    scale, near = ([*x[0], *x[1]] for x in zip(*limits))
    names = [f"{t}.{n}" for t in ("act", "crt")
             for n in trunk_cuda.WEIGHT_NAMES]
    flips = 0
    for name, k, w, sc, nz in zip(names, got, want, scale, near):
        diff = (k.double() - w).abs()
        tight = BWD_TOL * sc + nz
        if not gate:
            flips += int((diff > tight).sum())
        elif not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{what}: non-finite gradient of {name}")
        elif precision == "bf16":
            flips += flip_check(diff, tight, tight + BF16_ULP * sc,
                                f"{what}, {name}")
        elif not bool((diff <= tight).all()):
            raise AssertionError(f"{what} differs from the float64 plain "
                                 f"version on {name} by more than {BWD_TOL} "
                                 f"of its |terms| sum")
    return flips


@phase("trunk backward kernel vs plain")
def check_trunk_bwd(device, world: str, batch: int,
                    precision: str = "float32", f32_scans: bool = False):
    """The backward kernel against its plain version in float64 on the
    world's scans; in bf16 mode on bf16 scans with a bf16 cotangent, and
    with ``f32_scans`` also on float32 scans (held, not timed)."""
    import torch
    import torch.nn.functional as F

    from rl_collision_avoidance_torch import bench
    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.models import load_policy
    from rl_collision_avoidance_torch.ops import trunk_cuda

    spec = spec_of(world)
    dtype = trunk_cuda.PRECISIONS[precision]
    policy = load_policy(WORLD_PARAMS[world], device=device)
    act = [w.detach() for w in policy.trunk_weights("act")]
    crt = [w.detach() for w in policy.trunk_weights("crt")]
    flat = lambda pair: [*pair[0], *pair[1]]

    def hold(obs_dtype):
        env = Env(spec, device=device, seed=SEED + 2, obs_dtype=obs_dtype)
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 2)
        # the world's scans with three distinct frames: two acting steps
        # after reset
        state, obs = env.reset(-(-batch // spec.n_robots))
        _, obs, _ = bench.run_acting(env, policy, state, obs, 2, gen)
        scans = obs.scans.reshape(-1, spec.laser_frames,
                                  spec.n_beams)[:batch].contiguous()
        g = torch.randn((2, batch, 256), generator=gen,
                        device=device).to(dtype)
        got = flat(trunk_cuda.twin_trunks_grads(scans, act, crt, g,
                                                precision))
        again = flat(trunk_cuda.twin_trunks_grads(scans, act, crt, g,
                                                  precision))
        plain = flat(trunk_cuda.twin_trunks_grads_plain(scans, act, crt, g,
                                                        precision))
        want = flat(trunk_cuda.twin_trunks_grads_plain(
            scans.double(), [w.double() for w in act],
            [w.double() for w in crt], g.double(), precision))
        if device.type == "cuda":
            torch.cuda.synchronize()  # a fault inside the kernel shows here
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("two launches of the trunk backward kernel "
                                 "on the same inputs differ")
        limits = trunk_grads_limits(scans, act, crt, g, precision)
        flips = check_grads(got, want, limits, precision,
                            f"trunk backward kernel ({precision}, "
                            f"{scans.dtype} scans)")
        plain_flips = check_grads(plain, want, limits, precision, "",
                                  gate=False)
        scale, near = ([*x[0], *x[1]] for x in zip(*limits))
        worst = {who: max(float(((v.double() - w).abs()
                                 / (BWD_TOL * sc + nz).clamp(min=1e-30)
                                 ).max())
                          for v, w, sc, nz in zip(vs, want, scale, near))
                 for who, vs in (("kernel", got), ("plain", plain))}
        err = max(float((k - p).abs().max()) for k, p in zip(got, plain))
        top = max(float(w.abs().max()) for w in want)
        print(f"trunk backward: {world} scans ({scans.dtype}), {precision}, "
              f"B = {batch} ({trunk_cuda.plan_for(scans, precision)}); worst "
              f"|error| / limit against the float64 plain version: kernel "
              f"{worst['kernel']:.3g}, float32 plain version "
              f"{worst['plain']:.3g}; elements beyond the float32 rule: "
              f"kernel {flips}, plain {plain_flips}; max |kernel - plain| = "
              f"{err:.3g} with gradients up to {top:.3g}; two launches "
              f"bit-equal", flush=True)
        return scans, g, err

    scans, g, err = hold(dtype)
    if f32_scans:
        hold(torch.float32)

    b, frames, beams = scans.shape
    _, per_sample = trunk_ops(frames, beams)
    nbytes = (scans.numel() * scans.element_size() + g.numel() * g.element_size()
              + 2 * 4 * sum(w.numel() for w in (*act, *crt)))
    record = {"name": "twin_trunks_grads", "route": "cuda",
              "source": "rl_collision_avoidance_torch/ops/csrc/trunk_bwd.cu",
              "replaces": "rl_collision_avoidance_tpu/ops/trunk_pallas.py:155",
              "world": world, "batch": b, "precision": precision,
              "max_abs_err": err}
    lib_x = scans.to(dtype)

    def library():  # autograd through the bare cuDNN / cuBLAS calls
        ws = [w.detach().to(dtype).requires_grad_() for w in (*act, *crt)]
        with trunk_cuda.exact_float32():
            outs = []
            for w1, b1, w2, b2, wf, bf in (ws[:6], ws[6:]):
                y = F.relu(F.conv1d(lib_x, w1, b1, stride=2, padding=1))
                y = F.relu(F.conv1d(y, w2, b2, stride=2, padding=1))
                outs.append(F.relu(F.linear(y.flatten(1), wf, bf)))
            torch.autograd.grad(outs, ws, (g[0], g[1]))

    if device.type == "cuda":
        record["ms"], record["host_us"] = time_ms(
            lambda: trunk_cuda.twin_trunks_grads(scans, act, crt, g,
                                                 precision), 5, 1)
        record.update(call_memory(
            lambda: trunk_cuda.twin_trunks_grads(scans, act, crt, g,
                                                 precision),
            ("twin_trunks_grads", b, precision), "trunk backward"))
        record["plain_ms"] = time_ms(
            lambda: trunk_cuda.twin_trunks_grads_plain(scans, act, crt, g,
                                                       precision), 5, 1)[0]
        record["library_ms"] = time_ms(library, 5, 1)[0]
    record["bound_ms"], record["bound_by"] = bound(
        nbytes, 2 * b * per_sample,
        BF16_OPS_PER_S if precision == "bf16" else F32_OPS_PER_S)
    return record


# The kernels' passes by the CUDA symbol names torch.profiler reports
# (demangled or not), in both modes (float32: FFMA kernels; bf16: the
# tensor-core conv_mma_kernel, conv_bwd_mma_kernel and mma_gemm_kernel): the
# conv passes, the product cores' instances (A and B k-contiguous or not,
# epilogue, then the bf16 core's types), their split-K reduce, the
# backward's reduces.
PASSES = (("conv_fwd_kernel|conv_mma_kernel", "conv pass"),
          ("conv_bwd_kernel|conv_bwd_mma_kernel", "conv_bwd"),
          ("splitk_reduce", "split-K reduce"),
          ("reduce_kernel|reduce_bf16_kernel|bias_rows_kernel|db2_kernel",
           "reduce"),
          ("gemm_kernel<true,true,1|ILb1ELb1ELi1E", "fc1 product"),
          ("gemm_kernel<true,true,2|ILb1ELb1ELi2E", "g1 product"),
          ("gemm_kernel<false,false,0|ILb0ELb0ELi0E", "dWf product"),
          ("gemm_kernel<true,false,3|ILb1ELb0ELi3E|gemm_kernel<true,false,4"
           "|ILb1ELb0ELi4E", "dflat product"))


@phase("trunk kernels by pass")
def pass_times(device):
    """Device ms of each pass of one forward and one backward launch at
    B = BWD_BATCH in each mode (bf16 on bf16 scans), from torch.profiler;
    "not measured" where the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rl_collision_avoidance_torch.models import load_policy
    from rl_collision_avoidance_torch.ops import trunk_cuda

    policy = load_policy(PARAMS, device=device)
    act = [w.detach() for w in policy.trunk_weights("act")]
    crt = [w.detach() for w in policy.trunk_weights("crt")]
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    scans = torch.rand((BWD_BATCH, 3, 512), generator=gen, device=device)
    g = torch.randn((2, BWD_BATCH, 256), generator=gen, device=device)
    out = {}
    x16, g16 = scans.to(torch.bfloat16), g.to(torch.bfloat16)
    for name, fn in (("twin_trunks",
                      lambda: trunk_cuda.twin_trunks(scans, act, crt)),
                     ("twin_trunks_grads",
                      lambda: trunk_cuda.twin_trunks_grads(scans, act, crt,
                                                           g)),
                     ("twin_trunks bf16",
                      lambda: trunk_cuda.twin_trunks(x16, act, crt, "bf16")),
                     ("twin_trunks_grads bf16",
                      lambda: trunk_cuda.twin_trunks_grads(x16, act, crt, g16,
                                                           "bf16"))):
        fn()
        torch.cuda.synchronize()
        with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) \
                as prof:
            fn()
            torch.cuda.synchronize()
        split = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            key = ev.key.replace(" ", "")
            for pattern, label in PASSES:
                if any(p in key for p in pattern.split("|")) and us > 0:
                    split[label] = split.get(label, 0.0) + us / 1e3
                    break
        out[name] = split or "not measured"
    print("passes (device ms, one launch at B = "
          f"{BWD_BATCH}, torch.profiler): {json.dumps(out)}", flush=True)


def run_training(device, card: str, cfg, params, updates: int,
                 min_goal: float | None, f64: bool = False):
    """``updates`` training updates of ``cfg`` (the first a warm-up) from
    the weights ``params``, through the kernels; checks the launch counts,
    finite losses, moved parameters, the goal share of ended episodes
    (unless ``min_goal`` is None) and the minibatch gradients against the
    plain path (``f64``: see compare_minibatch_grads), in the precision of
    ``cfg.policy_dtype``.  Returns (launches by (name, batch, precision),
    trainer, state, the metrics of each update)."""
    import torch

    from rl_collision_avoidance_torch.models.policy import PRECISION
    from rl_collision_avoidance_torch.train import Trainer
    from rl_collision_avoidance_torch.utils.params import (
        jax_params_to_torch, load_jax_npz)

    tr = Trainer(cfg, device=device)
    state = tr.init_state()
    state.policy.load_state_dict(jax_params_to_torch(load_jax_npz(params)))
    start_params = [p.detach().clone() for p in state.policy.parameters()]

    precision = PRECISION[cfg.policy_dtype]
    reset_counts()
    metrics, update_ms = [], []
    for _ in range(updates):
        (state, m), ms = timed(lambda: tr.train_step(state), device)
        metrics.append(m)
        update_ms.append(ms)
    mb = cfg.ppo.batch_size
    launches = read_counts()

    steps = metrics[0]["env_steps"]
    keys = ("policy_loss", "value_loss", "entropy", "episodes", "reached",
            "crashed", "reward_mean")
    for i, (m, ms) in enumerate(zip(metrics, update_ms)):
        tag = "warm-up" if i == 0 else f"timed {i}"
        rate = "" if ms is None else (f"; {ms:.1f} ms, "
                                      f"{steps / ms * 1e3:.1f} robot-steps/s")
        print(f"training: {cfg.world} ({precision}): update {i + 1} ({tag}): "
              + ", ".join(f"{k} {m[k]:.6g}" for k in keys) + rate, flush=True)
    (_, traj, last_value), rollout_ms = timed(lambda: tr._rollout(state),
                                              device)
    steps_per_update = steps // mb * cfg.ppo.epochs
    print(f"training: {cfg.world} ({precision}, scans "
          f"{traj['scans'].dtype}): {cfg.n_arenas} arenas x "
          f"{tr.spec.n_robots} robots x horizon {cfg.horizon} = {steps} "
          f"samples/update, {steps_per_update} PPO steps of {mb}; rollout "
          f"buffer scans {traj['scans'].numel() * traj['scans'].element_size()}"
          f" bytes; kernel launches (name, batch, precision): {launches}",
          flush=True)
    if device.type == "cuda" and updates > 1:
        best = min(update_ms[1:])
        print(f"training: {cfg.world} ({precision}): best timed update "
              f"{best:.1f} ms = "
              f"{1e3 / best:.3f} updates/s, {steps / best * 1e3:.1f} "
              f"robot-steps/s (CUDA events); a rollout alone "
              f"{rollout_ms:.1f} ms, so PPO ~{best - rollout_ms:.1f} ms; on "
              f"{torch.cuda.get_device_name(device)} [{card}]", flush=True)

    finite = all(torch.isfinite(torch.tensor(m[k])) for m in metrics
                 for k in ("policy_loss", "value_loss", "entropy"))
    if not finite:
        raise AssertionError("non-finite loss in the training slice")
    moved = max(float((p.detach() - q).abs().max()) for p, q in
                zip(state.policy.parameters(), start_params))
    if not moved > 0:
        raise AssertionError("training left the parameters where they were")
    if device.type == "cuda" and launches != training_launches(
            tr, updates, steps_per_update):
        raise AssertionError(f"a kernel of the training path did not run as "
                             f"often as it should: {launches}")
    goal = sum(m["reached"] for m in metrics)
    ended = sum(m["episodes"] for m in metrics)
    share = goal / ended if ended else 0.0
    print(f"training: {cfg.world} ({precision}): goal share {share:.3f} of "
          f"{ended:.0f} "
          f"ended episodes", flush=True)
    if min_goal is not None and (ended == 0 or share < min_goal):
        raise AssertionError(f"the warm-started policy reached the goal in "
                             f"{goal} of {ended} episodes (< {min_goal})")
    compare_minibatch_grads(tr, state, traj, last_value, f64)
    return launches, tr, state, metrics


@contextlib.contextmanager
def eager_steps():
    """The acting step run eagerly on the card, as on the CPU: nothing is
    captured inside the block (``utils/graphs.captured_on`` reads False)."""
    from rl_collision_avoidance_torch.utils import graphs

    captured_on = graphs.captured_on
    graphs.captured_on = lambda device: False
    try:
        yield
    finally:
        graphs.captured_on = captured_on


def graphed_and_eager(run):
    """``run()`` twice, the first time with the acting step's graphs and
    the second eagerly, each in a fresh count; returns the two outputs, the
    (captures, replays) of the graphed run, the host us a step of each
    (``run`` returns (out, steps of its timed part, its host seconds)) and
    the launches the graphed run made beyond the eager one's, by (kernel,
    batch, precision)."""
    from rl_collision_avoidance_torch.utils import graphs

    outs, counts, us, launches = [], None, [], []
    for graphed in (True, False):
        reset_counts()
        with contextlib.nullcontext() if graphed else eager_steps():
            out, steps, seconds = run()
        if graphed:
            counts = (graphs.captures, graphs.replays)
        outs.append(out)
        us.append(seconds / steps * 1e6)
        launches.append(read_counts())
    more = {k: launches[0].get(k, 0) - launches[1].get(k, 0)
            for k in {*launches[0], *launches[1]}}
    return outs, counts, us, {k: v for k, v in more.items() if v}


def host_seconds(fn, device):
    """(fn(), host seconds of ``fn`` up to a synchronize after it)."""
    import torch

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


@phase("acting step graphs")
def check_graphs(device, card: str):
    """The acting step replayed from its CUDA graphs against the same step
    run eagerly (``utils/graphs.py``), bit for bit: two stage-1 rollouts at
    TRAIN_ARENAS arenas (768 robots) and two stage-2 rollouts at S2_ARENAS
    (704) from the trained weights on the generators' draws (the
    trajectory, the bootstrap value and the env state after each), and the
    circle eval at EVAL_ARENAS arenas (1,600 robots, EVAL_NOISE m of
    jitter) for GRAPH_EVAL_STEPS steps (every action handed to
    ``Env.step``, each robot's first result and its step).  Prints the host
    us a step both ways (the second rollout or call, which replays, up to
    a synchronize) and the graph counts.  The kernels' launch counts of the
    two ways differ by the policy graph's warm-up runs alone: each replay
    counts the forward it launches."""
    import dataclasses

    import torch

    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.eval import circle as circle_eval
    from rl_collision_avoidance_torch.models import load_policy
    from rl_collision_avoidance_torch.train import TrainConfig, Trainer
    from rl_collision_avoidance_torch.utils import graphs
    from rl_collision_avoidance_torch.utils.params import (
        jax_params_to_torch, load_jax_npz)
    from rl_collision_avoidance_torch.worlds import circle

    def rollouts(cfg):
        tr = Trainer(cfg, device=device)
        state = tr.init_state()
        state.policy.load_state_dict(jax_params_to_torch(load_jax_npz(
            PARAMS)))
        out = []
        for _ in range(2):
            (env_state, traj, value), seconds = host_seconds(
                lambda: tr._rollout(state), device)
            state = dataclasses.replace(state, env_state=env_state)
            out += [*(traj[k].clone() for k in sorted(traj)), value,
                    *vars(env_state).values()]
        return out, cfg.horizon, seconds

    def episodes():
        policy = load_policy(CIRCLE_PARAMS, device=device)
        env = Env(circle(), device=device, seed=SEED)
        gen = torch.Generator(device=device).manual_seed(SEED)
        noise = circle_eval.pose_noise_draw(EVAL_ARENAS, env.n_robots,
                                            EVAL_NOISE, gen)
        actions, env_step = [], env.step

        def step(state, action, *args, **kwargs):
            actions.append(action.clone())
            return env_step(state, action, *args, **kwargs)

        env.step = step
        first = circle_eval.run_episodes(policy, env, EVAL_ARENAS,
                                         GRAPH_EVAL_STEPS, noise)
        del env.step
        again, seconds = host_seconds(lambda: circle_eval.run_episodes(
            policy, env, EVAL_ARENAS, GRAPH_EVAL_STEPS, noise), device)
        return [*first, *again, *actions], GRAPH_EVAL_STEPS, seconds

    s1 = TrainConfig.stage1(n_arenas=TRAIN_ARENAS, seed=SEED)
    s2 = TrainConfig.stage2(n_arenas=S2_ARENAS, seed=SEED)
    for what, robots, run, want in (
            ("stage-1 rollouts", s1.n_arenas * 24, lambda: rollouts(s1),
             (1, 2 * s1.horizon)),
            ("stage-2 rollouts", s2.n_arenas * 44, lambda: rollouts(s2),
             (1, 2 * s2.horizon)),
            ("circle eval", EVAL_ARENAS * 50, episodes,
             (2, 2 * 2 * GRAPH_EVAL_STEPS))):
        what = f"{what}, {robots} robots"
        (graphed, eager), counts, us, more = graphed_and_eager(run)
        same = len(graphed) == len(eager) and all(
            torch.equal(a, b) for a, b in zip(graphed, eager))
        print(f"graphs: {what}: graphed bit-equal to eager: {same} "
              f"({len(graphed)} tensors); host us a step graphed "
              f"{us[0]:.1f}, eager {us[1]:.1f}; graphs captured {counts[0]}, "
              f"replayed {counts[1]}; launches beyond eager's {more} "
              f"[{card}]", flush=True)
        if not same:
            raise AssertionError(f"graphs: {what}: the graphed step left "
                                 f"the eager step's bits")
        if counts != want:
            raise AssertionError(f"graphs: {what}: (captures, replays) "
                                 f"{counts}, not {want}")
        if more != {("twin_trunks", robots, "float32"): graphs.WARMUP}:
            raise AssertionError(f"graphs: {what}: the graphed run's "
                                 f"launches beyond the eager run's are "
                                 f"{more}, not the forward's "
                                 f"{graphs.WARMUP} warm-up runs")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def flat_grad_numel() -> int:
    """Floats in the policy's flattened gradient, the buffer that
    ``ppo_update`` all-reduces once a minibatch."""
    from rl_collision_avoidance_torch.models import CNNPolicy

    return sum(p.numel() for p in CNNPolicy().parameters())


def time_all_reduce(device, iters: int = 20) -> float:
    """ms of one all-reduce of the flattened gradient in the current
    process group (host clock around synchronized calls, so the same
    measure for NCCL and for gloo, whose CUDA path stages through the
    host)."""
    import torch

    from rl_collision_avoidance_torch.parallel import all_reduce_sum

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    flat = torch.ones(flat_grad_numel(), device=device)
    for _ in range(3):
        all_reduce_sum(flat)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        all_reduce_sum(flat)
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


def train_updates(tr, updates: int):
    """``updates`` updates of a trainer warm-started from PARAMS, counted
    from 0 launches; returns (state, the metrics of each update, the
    launches, the ms of each update from CUDA events)."""
    from rl_collision_avoidance_torch.utils.params import (
        jax_params_to_torch, load_jax_npz)

    state = tr.init_state()
    state.policy.load_state_dict(jax_params_to_torch(load_jax_npz(PARAMS)))
    reset_counts()
    metrics, update_ms = [], []
    for _ in range(updates):
        (state, m), ms = timed(lambda: tr.train_step(state), tr.device)
        metrics.append(m)
        update_ms.append(ms)
    return state, metrics, read_counts(), update_ms


@phase("multi-process, 1 rank (NCCL)")
def run_one_rank_nccl(device, card: str, cfg, updates: int, want_params,
                      want_metrics):
    """Stage-1 training of ``cfg`` from PARAMS in a one-rank NCCL group on
    a free port: ``updates`` updates with the collectives running, which
    must end bit-equal to the one-process slice (``want_params``,
    ``want_metrics``).  Returns (the launches, the ms of one NCCL
    all-reduce of the flattened gradient)."""
    import torch

    from rl_collision_avoidance_torch import parallel
    from rl_collision_avoidance_torch.train import Trainer

    parallel.setup_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                               device=device)
    try:
        if device.type == "cuda" and torch.distributed.get_backend() != "nccl":
            raise AssertionError("the one-rank group on the card is not NCCL")
        tr = Trainer(cfg, device=device)
        state, metrics, launches, update_ms = train_updates(tr, updates)
        steps = metrics[0]["env_steps"] // cfg.ppo.batch_size * cfg.ppo.epochs
        want = training_launches(tr, updates, steps)
        ms = time_all_reduce(device)
    finally:
        parallel.teardown()
    same = (metrics == want_metrics and all(
        torch.equal(v, want_params[k])
        for k, v in state.policy.state_dict().items()))
    print(f"multi-process: 1 NCCL rank, {cfg.n_arenas} arenas, {updates} "
          f"updates: params and metrics bit-equal to the one-process slice: "
          f"{same}; kernel launches (name, batch, precision): {launches}; "
          f"update ms (CUDA events; the first a warm-up) {update_ms}; an "
          f"all-reduce of the {flat_grad_numel()}-float gradient {ms:.4g} "
          f"ms [{card}]", flush=True)
    if not same:
        raise AssertionError("one-rank NCCL training left the one-process "
                             "path's bits")
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"a kernel of the one-rank path did not run as "
                             f"often as it should: {launches}")
    return launches, ms


def synthetic_minibatch(device):
    """One stage-1 minibatch of BWD_BATCH samples from MB_SEED, built with
    numpy so that every process builds the same bits: scans uniform over
    the normalized range, actions drawn around random means with the
    PARAMS policy's std and their log-probabilities under those means,
    advantages and targets standard normal, 10% of the weights 0."""
    import math

    import numpy as np
    import torch

    from rl_collision_avoidance_torch.algo.ppo import Batch
    from rl_collision_avoidance_torch.utils.params import load_jax_npz

    logstd = np.asarray(load_jax_npz(PARAMS)["params"]["logstd"],
                        np.float64).reshape(2)
    rng = np.random.default_rng(MB_SEED)
    m = BWD_BATCH
    put = lambda a: torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.float32)).to(device)
    unit = lambda: np.stack([rng.uniform(0, 1, m), rng.uniform(-1, 1, m)], -1)
    mu, eps = unit(), rng.standard_normal((m, 2))
    logprob = (-0.5 * eps ** 2 - 0.5 * math.log(2 * math.pi)
               - logstd).sum(-1, keepdims=True)
    return Batch(scans=put(rng.uniform(-0.5, 0.5, (m, 3, 512))),
                 goal=put(rng.normal(0.0, 2.0, (m, 2))), speed=put(unit()),
                 action=put(mu + np.exp(logstd) * eps), logprob=put(logprob),
                 target=put(rng.standard_normal((m, 1))),
                 adv=put(rng.standard_normal((m, 1))),
                 weight=put(rng.uniform(size=m) > 0.1))


def split_update(device):
    """One ``ppo_update`` (one epoch, one minibatch of BWD_BATCH, in order)
    of the synthetic minibatch from PARAMS, as the trainer runs it: this
    process's share of the minibatch (its rank's 1 / W, the whole of it
    without a group), the advantages normalized over every rank's by
    ``normalize_shard_advantages``.  Returns (the gradients the update
    left, which Adam stepped on: summed over the ranks; the params after;
    the minibatch's policy, value and entropy losses, global)."""
    import torch

    from rl_collision_avoidance_torch import parallel
    from rl_collision_avoidance_torch.algo.ppo import (
        Batch, normalize_shard_advantages, ppo_update)
    from rl_collision_avoidance_torch.models import load_policy
    from rl_collision_avoidance_torch.train import TrainConfig

    cfg = TrainConfig.stage1(n_arenas=TRAIN_ARENAS).ppo._replace(
        batch_size=BWD_BATCH, epochs=1)
    policy = load_policy(PARAMS, device=device)
    optimizer = torch.optim.Adam(policy.parameters(), lr=cfg.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    m = BWD_BATCH // parallel.world_size()
    r = parallel.rank()
    mb = Batch(*(x[r * m:(r + 1) * m] for x in synthetic_minibatch(device)))
    mb = mb._replace(adv=normalize_shard_advantages(mb.adv))
    out = ppo_update(policy, optimizer, mb, cfg,
                     torch.arange(m, device=device)[None])
    params = list(policy.parameters())
    return ([p.grad for p in params], [p.detach() for p in params],
            out["minibatches"][0].tolist())


def params_sha256(params) -> str:
    import hashlib

    digest = hashlib.sha256()
    for v in params:
        digest.update(v.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def mp_rank(rank: int, url: str, out: str, device: str) -> int:
    """One of the MP_RANKS gloo ranks on ``device``, ``cuda:0`` on the card
    (the ``mp-rank`` arguments): stage-1 training of its TRAIN_ARENAS /
    MP_RANKS arenas for 1 + TRAIN_UPDATES updates from PARAMS in float32
    and then in bf16, its half of the synthetic minibatch's update
    (split_update), and the time of a gloo all-reduce of the flattened
    gradient on CUDA tensors.  Writes ``out`` as JSON: per mode and for
    the split update the sha256 of the params' bytes, the global metrics
    or losses, and the training launches; rank 0 also saves the split
    update's gradients and params beside it."""
    sys.path.insert(0, str(ROOT))
    import torch

    from rl_collision_avoidance_torch import parallel
    from rl_collision_avoidance_torch.train import TrainConfig, Trainer

    device = torch.device(device)
    parallel.setup_distributed(url, MP_RANKS, rank, backend="gloo",
                               device=device)
    result = {"rank": rank}
    try:
        for precision in ("float32", "bf16"):
            dtype = torch.bfloat16 if precision == "bf16" else None
            cfg = TrainConfig.stage1(n_arenas=TRAIN_ARENAS, seed=SEED,
                                     policy_dtype=dtype or torch.float32,
                                     obs_store_dtype=dtype)
            tr = Trainer(cfg, device=device)
            state, metrics, launches, _ = train_updates(tr, 1 + TRAIN_UPDATES)
            steps = (metrics[0]["env_steps"] // cfg.ppo.batch_size
                     * cfg.ppo.epochs)
            if device.type == "cuda" and launches != training_launches(
                    tr, len(metrics), steps):
                raise AssertionError(f"rank {rank} ({precision}): a kernel "
                                     f"did not run as often as it should: "
                                     f"{launches}")
            result[precision] = {
                "sha256": params_sha256(state.policy.state_dict().values()),
                "metrics": metrics,
                "launches": [[*k, v] for k, v in launches.items()]}
            del tr, state
        grads, params, losses = split_update(device)
        result["split"] = {"sha256": params_sha256(params), "losses": losses}
        if rank == 0:
            result["split_file"] = f"{out}.split.pt"
            torch.save([[t.cpu() for t in grads], [t.cpu() for t in params]],
                       result["split_file"])
        result["allreduce_ms"] = time_all_reduce(device)
    finally:
        parallel.teardown()
    Path(out).write_text(json.dumps(result))
    return 0


@phase("multi-process, 2 ranks on one card (gloo)")
def run_two_ranks(device, card: str) -> dict:
    """MP_RANKS worker processes of the port on ``device`` (mp_rank),
    joined by gloo through a file store, each within MP_TIMEOUT seconds.
    Gates: every rank exits 0 and writes its result; in each mode the
    ranks' params hash alike, their global metrics are equal and the goal
    share of ended episodes is at least MP_MIN_GOAL; and the split
    update of the synthetic minibatch (split_update) against one process's
    update of the whole: the ranks' params bit-equal, the gradient Adam
    stepped on within GRAD_ATOL and GRAD_NORM, every parameter moved
    alike (see check_split_update), and the value and entropy losses within
    GRAD_NORM relative.  Returns the launches merged over the ranks by mode,
    and the ms of one gloo all-reduce."""
    import tempfile

    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"rank{r}.json" for r in range(MP_RANKS)]
        logs = [open(Path(tmp) / f"rank{r}.log", "w+")
                for r in range(MP_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "mp-rank", str(r),
             f"file://{tmp}/store", str(outs[r]), str(device)], cwd=ROOT,
            stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(MP_RANKS)]
        deadline = time.perf_counter() + MP_TIMEOUT
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            log.close()
            if p.returncode != 0 or not outs[r].is_file():
                raise AssertionError(f"rank {r} exited {p.returncode} "
                                     f"without a result:\n{text[-4000:]}")
        results = [json.loads(o.read_text()) for o in outs]
        got = torch.load(results[0]["split_file"])
    merged = {}
    for precision, path in (("float32", "training, 2 ranks"),
                            ("bf16", "training, 2 ranks, bf16")):
        runs = [res[precision] for res in results]
        if len({run["sha256"] for run in runs}) != 1:
            raise AssertionError(f"{path}: the ranks' params differ: "
                                 f"{[run['sha256'] for run in runs]}")
        if any(run["metrics"] != runs[0]["metrics"] for run in runs):
            raise AssertionError(f"{path}: the ranks' global metrics differ")
        counts = {}
        for run in runs:
            for *key, k in run["launches"]:
                counts[tuple(key)] = counts.get(tuple(key), 0) + k
        merged[precision] = counts
        metrics = runs[0]["metrics"]
        goal = sum(m["reached"] for m in metrics)
        ended = sum(m["episodes"] for m in metrics)
        for i, m in enumerate(metrics):
            print(f"{path}: update {i + 1}: " + ", ".join(
                f"{k} {m[k]:.6g}" for k in ("policy_loss", "value_loss",
                                            "entropy", "episodes", "reached",
                                            "crashed", "reward_mean")),
                  flush=True)
        print(f"{path}: {MP_RANKS} gloo ranks on {card}, {TRAIN_ARENAS} "
              f"arenas: params sha256 {runs[0]['sha256'][:16]} on every "
              f"rank; goal share {goal / max(ended, 1):.3f} of {ended:.0f} "
              f"ended episodes; kernel launches over the ranks (name, batch, "
              f"precision): {counts}", flush=True)
        if ended == 0 or goal / ended < MP_MIN_GOAL:
            raise AssertionError(f"{path}: goal share {goal} of {ended} "
                                 f"ended episodes (< {MP_MIN_GOAL})")
    check_split_update(device, results, got)
    return {**merged, "allreduce_ms": results[0]["allreduce_ms"]}


def check_split_update(device, results, got) -> None:
    """The MP_RANKS ranks' split update (their ``results``, rank 0's
    gradients and params ``got``) against split_update of the whole
    synthetic minibatch in this process.  Each gradient leaf must lie
    within GRAD_ATOL of its largest value and GRAD_NORM in relative 2-norm.
    Adam's first step moves a parameter by lr g / (|g| + eps), at most lr,
    so where the two gradients agree in sign away from zero the two params
    agree to rounding: a parameter whose steps differ by more than lr / 2
    must have a gradient within GRAD_ATOL of zero.  The global value and
    entropy losses must agree within GRAD_NORM relative."""
    import torch

    from rl_collision_avoidance_torch.models import CNNPolicy
    from rl_collision_avoidance_torch.train import TrainConfig

    runs = [res["split"] for res in results]
    if len({run["sha256"] for run in runs}) != 1:
        raise AssertionError(f"split update: the ranks' params differ: "
                             f"{[run['sha256'] for run in runs]}")
    lr = TrainConfig.stage1(n_arenas=TRAIN_ARENAS).ppo.learning_rate
    names = [n for n, _ in CNNPolicy().named_parameters()]
    want_grads, want_params, want_losses = split_update(device)
    worst = {"el": 0.0, "norm": 0.0, "moved": 0}
    got_grads, got_params = got
    for name, ga, gb, pa, pb in zip(names, got_grads, want_grads, got_params,
                                    want_params):
        ga, gb = ga.to(device).double(), gb.double()
        scale = float(gb.abs().max())
        el = float((ga - gb).abs().max()) / max(scale, 1e-30)
        nrm = float((ga - gb).norm() / gb.norm().clamp(min=1e-30))
        moved = (pa.to(device) - pb).abs() > lr / 2
        worst = {"el": max(worst["el"], el), "norm": max(worst["norm"], nrm),
                 "moved": worst["moved"] + int(moved.sum())}
        if not (el <= GRAD_ATOL and nrm <= GRAD_NORM):
            raise AssertionError(f"the {MP_RANKS}-rank gradient of {name} "
                                 f"differs from the one-process one by "
                                 f"{el:.3g} of its largest value, {nrm:.3g} "
                                 f"in relative 2-norm")
        if bool((gb[moved].abs() > GRAD_ATOL * scale).any()):
            raise AssertionError(f"{name}: a parameter with a gradient beyond "
                                 f"GRAD_ATOL of zero stepped differently on "
                                 f"{MP_RANKS} ranks and in one process")
    have_losses = runs[0]["losses"]
    for i, what in ((1, "value"), (2, "entropy")):
        rel = abs(have_losses[i] - want_losses[i]) / abs(want_losses[i])
        if not rel <= GRAD_NORM:
            raise AssertionError(f"split update: the {what} loss is "
                                 f"{have_losses[i]} on {MP_RANKS} ranks, "
                                 f"{want_losses[i]} in one process")
    print(f"multi-process: one ppo_update of a {BWD_BATCH}-sample minibatch "
          f"split over {MP_RANKS} ranks against one process's: gradient "
          f"worst leaf {worst['el']:.3g} of its largest value (limit "
          f"{GRAD_ATOL}), {worst['norm']:.3g} in relative 2-norm (limit "
          f"{GRAD_NORM}); {worst['moved']} parameters stepped differently, "
          f"all with a gradient within GRAD_ATOL of zero; losses (policy, "
          f"value, entropy) {have_losses} against {want_losses}", flush=True)


def training_launches(tr, updates: int, steps_per_update: int) -> dict:
    """The launches ``updates`` updates of a fresh trainer ``tr`` make (on
    its rank, in a process group): the rollout's horizon acting steps and
    its bootstrap at the rank's arena batch each, one forward and one
    backward for each of the rank's PPO minibatches.  The acting step runs
    from a CUDA graph, whose replays launch its forward; before its
    capture, its ``graphs.WARMUP`` warm-up runs launch it too."""
    from rl_collision_avoidance_torch.models.policy import PRECISION
    from rl_collision_avoidance_torch.utils import graphs

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


def conv_pieces(scans, act, crt, kernel: bool, precision: str = "float32"):
    """(2, B, 3 * 4,096) booleans: per trunk and sample, which conv2 ReLUs
    and which conv1 ReLUs (even positions, then odd) pass.  ``kernel``: as
    the kernels compute them, read through the forward kernel with selector
    weights: fc1 rows of the identity pass 256 of the 4,096 conv2 features
    unchanged, conv2 taps of the identity pass conv1's even or odd
    positions (exact in float32: one product by 1, the rest sums of
    zeros; in bf16 too, and rounding keeps the sign).  Otherwise as the
    plain trunks compute them."""
    import torch
    import torch.nn.functional as F

    from rl_collision_avoidance_torch.ops import trunk_cuda

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
    import torch

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

    import torch

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


def compare_minibatch_grads(tr, state, traj, last_value, f64: bool):
    """The parameter gradients of GRAD_MINIBATCHES minibatches' PPO loss
    through the kernels (TwinTrunks) against autograd through the plain
    trunks, on the samples where both take the same pieces (see
    MAX_FLIP_SHARE); with ``f64``, a leaf that misses that rule against the
    float64 plain path (see float64_grads).  A bf16 policy's plain path is
    the plain bf16 trunks and the same bf16 tail."""
    import torch

    from rl_collision_avoidance_torch.algo.ppo import Batch, ppo_loss
    from rl_collision_avoidance_torch.models.policy import PRECISION
    from rl_collision_avoidance_torch.ops import trunk_cuda

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
        flips = {k: (pk[k] != pp[k]).any(dim=-1) for k in pk}
        flipped = torch.stack(list(flips.values())).any(dim=0)
        n_flip = int(flipped.sum())
        if n_flip > MAX_FLIP_SHARE * cfg.batch_size:
            raise AssertionError(f"minibatch {trial}: {n_flip} samples take "
                                 f"other pieces through the kernels than "
                                 f"through the plain trunks")
        # all samples first: what the flips do
        got, want = grads(mb)
        with_them = {crt: max(((n, rel(a, b)) for n, a, b in
                               zip(names, got, want)
                               if n.startswith(("crt", "critic")) == crt),
                              key=lambda t: t[1])
                     for crt in (False, True)}
        kept = mb._replace(weight=mb.weight * ~flipped)
        got, want = grads(kept) if n_flip else (got, want)
        exact, misses, worst = None, [], {"el": 0.0, "norm": 0.0}
        bf16_worst = 0.0
        for name, a, b in zip(names, got, want):
            el, nrm = peak(a, b), rel(a, b)
            if precision == "bf16" and not name.startswith(TRUNK_LEAVES):
                ulp = (a - b).abs() <= torch.clamp(BF16_ULP * b.abs(),
                                                   min=GRAD_ATOL
                                                   * float(b.abs().max()))
                if not (bool(ulp.all()) and nrm <= BF16_ULP):
                    raise AssertionError(
                        f"minibatch {trial}: bf16 gradient of {name} through "
                        f"the kernels differs from the plain path's by more "
                        f"than one ulp ({int((~ulp).sum())} elements) or "
                        f"{nrm:.3g} > {BF16_ULP} in relative 2-norm")
                bf16_worst = max(bf16_worst, nrm)
                continue
            worst = {"el": max(worst["el"], el),
                     "norm": max(worst["norm"], nrm)}
            if el <= GRAD_ATOL and nrm <= GRAD_NORM:
                continue
            if not f64:
                raise AssertionError(
                    f"minibatch {trial}: gradient of {name} through the "
                    f"kernels differs from the plain path's: {el:.3g} of its "
                    f"largest value, {nrm:.3g} in relative 2-norm")
            if exact is None:
                exact = float64_grads(policy, kept, cfg, plain)
            c, sc = exact[name]
            el64 = (float((a.double() - c).abs().max())
                    / max(float(sc.max()), 1e-30))
            k64 = float((a.double() - c).norm() / sc.norm().clamp(min=1e-30))
            p64 = float((b.double() - c).norm() / sc.norm().clamp(min=1e-30))
            ratio = float(sc.norm() / c.norm())
            misses.append(f"{name}: {nrm:.3g} from the plain path; from "
                          f"float64 {k64:.3g} of the |terms| scale (plain "
                          f"{p64:.3g}; the scale {ratio:.3g}x the gradient), "
                          f"{el64:.3g} of its largest value")
            if not (el64 <= GRAD_ATOL and k64 <= GRAD_NORM):
                raise AssertionError(
                    f"minibatch {trial}: gradient of {name} through the "
                    f"kernels differs from the plain path's by {nrm:.3g} in "
                    f"relative 2-norm, and from the float64 plain path's by "
                    f"{k64:.3g} of its |terms| scale (limit {GRAD_NORM}; the "
                    f"float32 plain path {p64:.3g}), {el64:.3g} of its "
                    f"largest value (limit {GRAD_ATOL})")
        with torch.no_grad():
            res = kept.weight[:, None] * (policy(kept.scans, kept.goal,
                                                 kept.speed)[0] - kept.target)
        kinds = ", ".join(f"{k} {int(v.sum())}" for k, v in flips.items())
        leaves = " and ".join(f"{n} {v:.3g}" for n, v in with_them.values())
        print(f"training: {tr.cfg.world} ({precision}): minibatch {trial} of "
              f"{cfg.batch_size}: {n_flip} samples take other pieces on the "
              f"two paths ({kinds}; limit "
              f"{MAX_FLIP_SHARE * cfg.batch_size:.0f}); with them the worst "
              f"leaves in relative 2-norm are {leaves}; "
              f"without them, kernels vs the plain path: worst leaf "
              f"{worst['el']:.3g} of its largest value (limit {GRAD_ATOL}), "
              f"{worst['norm']:.3g} in relative 2-norm (limit {GRAD_NORM})"
              + (f", the bf16 tail's leaves {bf16_worst:.3g} (limit "
                 f"{BF16_ULP})" if precision == "bf16" else "") + "; "
              f"value residual |sum| / sum|.| = "
              f"{float(res.sum().abs() / res.abs().sum()):.3g}; leaves held "
              f"to float64: {misses or 'none'}", flush=True)


@phase("circle eval")
def run_circle(device, card: str, arenas: int, noise: float,
               footprint: str = "disc", cull_k: int | None = None):
    """The circle-50 eval through ``run_circle_eval`` with the fine-tuned
    weights, ``arenas`` arenas at ``noise`` m of pose noise, up to
    EVAL_STEPS steps, with the world's ``footprint`` and, with ``cull_k``,
    the silhouettes culled to the k nearest (``env_kwargs``); prints the
    metrics beside the committed ones (TPU, results/circle_eval.json, or
    results/circle_eval_rect.json for the box) and the rate.  Returns the
    launches by (name, batch, precision)."""
    import dataclasses

    import torch

    from rl_collision_avoidance_torch.eval import run_circle_eval
    from rl_collision_avoidance_torch.models import load_policy
    from rl_collision_avoidance_torch.utils import graphs
    from rl_collision_avoidance_torch.worlds import circle

    rect = footprint == "rect"
    spec = dataclasses.replace(circle(), footprint=footprint)
    env_kwargs = {} if cull_k is None else {"disc_cull_k": cull_k}
    source = "circle_eval_rect.json" if rect else "circle_eval.json"
    key = ("rect_culled_deterministic" if cull_k else
           "rect_jitter_0.3m" if noise else "rect_deterministic") if rect \
        else ("jitter_0.1m" if noise else "deterministic")
    committed = json.loads((ROOT / "results" / source).read_text())[key]
    policy = load_policy(CIRCLE_PARAMS, device=device)
    reset_counts()
    t0 = time.perf_counter()
    metrics = run_circle_eval(policy, spec, max_steps=EVAL_STEPS, seed=SEED,
                              n_arenas=arenas, pose_noise=noise,
                              env_kwargs=env_kwargs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    robots = arenas * 50
    launches = read_counts()
    # one forward a step, after the policy graph's warm-up runs
    steps = launches.get(("twin_trunks", robots, "float32"), 0) - (
        graphs.WARMUP if device.type == "cuda" else 0)
    captured = graphs.captures
    what = (f"circle eval ({footprint}"
            + (f", culled to {cull_k}" if cull_k else "") + ")")
    print(f"{what}: {arenas} arena(s) at {noise} m: port (card) "
          f"{json.dumps(metrics)}", flush=True)
    print(f"{what}: {arenas} arena(s) at {noise} m: committed (TPU, "
          f"results/{source} {key}) {json.dumps(committed)}", flush=True)
    print(f"{what}: {steps} steps of {robots} robots in {wall:.2f} s "
          f"wall = {robots * steps / wall:.1f} robot-steps/s (all robots had "
          f"a result by step {steps}, or the limit); graphs captured "
          f"{captured}, replayed {graphs.replays}; kernel launches (name, "
          f"batch, precision): {launches} [{card}]", flush=True)
    lidar = ("lidar_obs_walls" if rect or cull_k else "lidar_obs", robots,
             "float32")
    env_step = set() if rect else {("env_physics", robots, "float32")}
    if device.type == "cuda" and not (
            launches.get(lidar) and set(launches) == {
                lidar, ("twin_trunks", robots, "float32"), *env_step}
            and captured == 2 and graphs.replays == 2 * steps):
        raise AssertionError(f"a kernel of the eval never ran, or ran at "
                             f"another batch, or the step's two graphs were "
                             f"not captured once each and replayed once a "
                             f"step: {launches}, {captured} captures, "
                             f"{graphs.replays} replays")
    if not rect:
        if arenas > 1 and not metrics["success_rate_mean"] >= EVAL_MIN_SUCCESS:
            raise AssertionError(f"circle eval success_rate_mean "
                                 f"{metrics['success_rate_mean']} < "
                                 f"{EVAL_MIN_SUCCESS} over {arenas} arenas")
    elif arenas > 1:
        if not metrics["success_rate_mean"] >= RECT_MIN_SUCCESS:
            raise AssertionError(f"{what}: success_rate_mean "
                                 f"{metrics['success_rate_mean']} < "
                                 f"{RECT_MIN_SUCCESS} over {arenas} arenas")
    elif not (metrics["success_rate"] == 1.0 and metrics["collisions"] == 0):
        raise AssertionError(f"{what}: the ring reached success "
                             f"{metrics['success_rate']} with "
                             f"{metrics['collisions']} collisions (the "
                             f"committed TPU run: 1.0, 0)")
    return launches


@phase("box silhouettes")
def time_silhouettes(device, card: str, world: str, arenas: int,
                     cull_k: int | None = None) -> dict:
    """Device ms and host us a call of the other robots' box silhouettes
    (``Env.silhouette_obs``: plain PyTorch, no TPU kernel) at the world's
    test poses, every box or the ``cull_k`` nearest."""
    import dataclasses

    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.worlds import get_world

    spec = dataclasses.replace(get_world(world), footprint="rect")
    env = Env(spec, device=device, seed=SEED, disc_cull_k=cull_k)
    pose = test_poses(env, arenas)
    a, n = pose.shape[:2]
    boxes = min(cull_k or n - 1, n - 1)
    out = {"name": "box_silhouettes", "route": "plain PyTorch, no TPU kernel",
           "world": world, "batch": a * n, "boxes_per_robot": boxes,
           "intermediate_bytes": 4 * a * n * spec.n_beams * boxes}
    out["ms"], out["host_us"] = time_ms(lambda: env.silhouette_obs(pose), 20)
    print(f"silhouettes: {json.dumps(out)} [{card}]", flush=True)
    return out


@phase("checkpoint round trip")
def checkpoint_round_trip(tr, state):
    """Save ``state``, take one update from it, restore the save into a
    fresh Trainer and take the update again: the two are bit-equal
    (parameters, Adam, every env tensor, both generators, the metrics)."""
    import dataclasses
    import tempfile

    import torch

    from rl_collision_avoidance_torch.train import Trainer
    from rl_collision_avoidance_torch.utils.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        mgr.save(state.update, tr.state_dict(state))
        fresh = Trainer(tr.cfg, device=tr.device)
        resumed = fresh.load_state_dict(mgr.restore(state.update, tr.device))
    ahead, m_ahead = tr.train_step(state)
    again, m_again = fresh.train_step(resumed)
    pairs = [*zip(ahead.policy.state_dict().values(),
                  again.policy.state_dict().values()),
             *((getattr(ahead.env_state, f.name),
                getattr(again.env_state, f.name))
               for f in dataclasses.fields(ahead.env_state)),
             (ahead.generator.get_state(), again.generator.get_state()),
             (tr.env.generator.get_state(), fresh.env.generator.get_state())]
    sa, sb = ahead.optimizer.state_dict(), again.optimizer.state_dict()
    pairs += [(v, sb["state"][i][k]) for i, st in sa["state"].items()
              for k, v in st.items()]
    same = all(torch.equal(a, b) for a, b in pairs) and m_ahead == m_again
    print(f"checkpoint: {tr.cfg.world}, saved after update {state.update}, "
          f"restored into a fresh Trainer: the next update bit-equal to the "
          f"unbroken one: {same} ({len(pairs)} tensors and the metrics)",
          flush=True)
    if not same:
        raise AssertionError("the update after a checkpoint round trip "
                             "differs from the unbroken update")


@phase("world compiler")
def check_world_compiler(device, card: str):
    """Compile stage 1, stage 2 and the circle rink from the port's assets
    (its own PNG reader: no PIL here) and hold each to its committed table,
    bit for bit; then one env step of TRAIN_ARENAS arenas on the compiled
    stage-1 world against the same step on the committed one."""
    import dataclasses
    import importlib.util

    import numpy as np
    import torch

    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.worlds import compile_world, get_world

    for name in ("stage1", "stage2", "circle"):
        t0 = time.perf_counter()
        built = compile_world(name)
        secs = time.perf_counter() - t0
        table = get_world(name)
        same = all(np.array_equal(getattr(built, f), getattr(table, f))
                   and getattr(built, f).dtype == getattr(table, f).dtype
                   for f in ("seg_p", "seg_e", "seg_valid"))
        print(f"world compiler: {name}: {int(built.seg_valid.sum())} "
              f"segments compiled from its assets in {secs:.3f} s (host "
              f"clock); bit-equal to the committed table: {same} [{card}]",
              flush=True)
        if not same:
            raise AssertionError(f"the compiled {name} differs from its "
                                 f"committed table")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("PIL", "matplotlib"))
    print(f"world compiler: PIL importable here: "
          f"{importlib.util.find_spec('PIL') is not None}; loaded image "
          f"modules: {loaded}", flush=True)
    if loaded:
        raise AssertionError(f"the world compiler loaded {loaded}")

    outs = []
    for spec in (compile_world("stage1"), get_world("stage1")):
        env = Env(spec, device=device, seed=SEED)
        state, _ = env.reset(TRAIN_ARENAS)
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        act = torch.rand((TRAIN_ARENAS, spec.n_robots, 2), generator=gen,
                         device=device) * 2 - 0.5
        reset_counts()
        out = env.step(state, act)
        launches = read_counts()
        if device.type == "cuda" and not launches.get(
                ("lidar_obs", TRAIN_ARENAS * spec.n_robots, "float32")):
            raise AssertionError(f"the step launched no lidar kernel: "
                                 f"{launches}")
        outs.append([t for o in out for t in (
            [getattr(o, f.name) for f in dataclasses.fields(o)]
            if dataclasses.is_dataclass(o) else [o])])
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    print(f"world compiler: one step of {TRAIN_ARENAS} arenas on the "
          f"compiled stage-1 world bit-equal to the committed world's: "
          f"{same} ({len(outs[0])} tensors; lidar kernel launches "
          f"{launches})", flush=True)
    if not same:
        raise AssertionError("an env step on the compiled stage-1 world "
                             "differs from the committed world's")


@phase("curriculum")
def run_curriculum(device, card: str) -> list:
    """``examples/train_curriculum.curriculum`` at full width, cut in depth
    (CURRICULUM_UPDATES, a checkpoint every update, CURRICULUM_EVAL_STEPS),
    into a temporary root, with the launch counts set to 0 just before and
    read just after.  Checks its files, that its training metrics and
    params are finite, the eval's shape, and the launches of each stage
    (the eval's: lidar and trunk forward at the ring's and the jittered
    arenas' batches).  Returns the (path, world, launches) of its three
    stages, the launches split by batch."""
    import csv
    import math
    import os
    import tempfile

    import torch

    from rl_collision_avoidance_torch.examples import train_curriculum
    from rl_collision_avoidance_torch.train import TrainConfig, Trainer
    from rl_collision_avoidance_torch.utils.params import (
        jax_params_to_torch, load_jax_npz)

    cfgs = {"stage1": TrainConfig.stage1(n_arenas=TRAIN_ARENAS),
            "stage2": TrainConfig.stage2(n_arenas=S2_ARENAS)}
    with tempfile.TemporaryDirectory() as root:
        reset_counts()
        t0 = time.perf_counter()
        out = train_curriculum.curriculum(
            updates=(CURRICULUM_UPDATES, CURRICULUM_UPDATES),
            n_arenas=(TRAIN_ARENAS, S2_ARENAS, CURRICULUM_EVAL_ARENAS),
            checkpoint_every=1, max_steps=CURRICULUM_EVAL_STEPS, root=root,
            device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches = read_counts()
        for stage in cfgs:
            params = jax_params_to_torch(load_jax_npz(out[f"{stage}_params"]))
            with open(os.path.join(root, "log", stage, "metrics.csv")) as f:
                rows = list(csv.DictReader(f))
            best = os.path.join(root, "checkpoints", stage, "best", "state.pt")
            finite = (all(bool(torch.isfinite(v).all())
                          for v in params.values())
                      and all(math.isfinite(float(r[k])) for r in rows
                              for k in ("policy_loss", "value_loss",
                                        "entropy", "reward_mean")))
            print(f"curriculum: {stage}: {len(rows)} updates logged, best "
                  f"checkpoint {os.path.isfile(best)}, params and metrics "
                  f"finite {finite}: "
                  + ", ".join(f"{k} {float(rows[-1][k]):.6g}" for k in
                              ("policy_loss", "value_loss", "entropy",
                               "episodes", "reached")), flush=True)
            if not (len(rows) == CURRICULUM_UPDATES and os.path.isfile(best)
                    and finite):
                raise AssertionError(f"curriculum: {stage} left no log, no "
                                     f"best checkpoint or a non-finite value")
    ring, jitter = (out["eval"][k] for k in ("deterministic_symmetric",
                                              "jitter_1.0m"))
    if not (ring["n_robots"] == jitter["n_robots"] == 50
            and jitter["n_arenas"] == CURRICULUM_EVAL_ARENAS
            and 0.0 <= jitter["success_rate_mean"] <= 1.0):
        raise AssertionError(f"curriculum: a malformed eval {out['eval']}")
    print(f"curriculum: stage 1 ({TRAIN_ARENAS} arenas), stage 2 "
          f"({S2_ARENAS}), {CURRICULUM_UPDATES} updates each, and the eval "
          f"(the ring, {CURRICULUM_EVAL_ARENAS} arenas at 1.0 m, up to "
          f"{CURRICULUM_EVAL_STEPS} steps) in {wall:.2f} s wall on "
          f"{device} [{card}]; kernel launches (name, batch, precision): "
          f"{launches}", flush=True)

    paths, expected = [], {}
    for stage, cfg in cfgs.items():
        tr = Trainer(cfg, device=device)
        steps = (cfg.horizon * tr.n_local * tr.spec.n_robots
                 // cfg.ppo.batch_size * cfg.ppo.epochs)
        want = training_launches(tr, CURRICULUM_UPDATES, steps)
        # the stage's init_state resets its arenas: one more lidar pass
        want[next(k for k in want if k[0].startswith("lidar"))] += 1
        expected.update(want)
        paths.append((f"curriculum, {stage}", cfg.world,
                      {k: launches.get(k, 0) for k in want}))
    evals = {k: v for k, v in launches.items() if k not in expected}
    paths.append(("curriculum, eval", "circle", evals))
    if device.type != "cuda":
        return paths
    robots = {50, CURRICULUM_EVAL_ARENAS * 50}
    if {(n, b) for n, b, _ in evals} != {(n, b) for n in (
            "lidar_obs", "twin_trunks", "env_physics") for b in robots}:
        raise AssertionError(f"curriculum: the eval's kernels did not run "
                             f"at its batches: {evals}")
    got = {k: launches[k] for k in expected if k in launches}
    if got != expected:
        raise AssertionError(f"curriculum: the training stages launched "
                             f"{got}, not {expected}")
    return paths


def pipeline_paths(name: str, launches: dict, train_cfg, device,
                   ring_12: bool) -> list:
    """The (path, world, launches) of one pipeline run, its launches split
    by batch: the fine-tune's (exactly as PIPELINE_UPDATES updates of
    ``train_cfg`` and the reset of its arenas launch them), the selection
    evals' at SELECT_ARENAS arenas, and the final evals' (the ring and the
    jittered arenas in the circle and, with ``ring_12``, the 12-robot
    ring): every eval runs the kernels in float32, whatever the training
    precision."""
    from rl_collision_avoidance_torch.examples import make_results
    from rl_collision_avoidance_torch.train import Trainer

    tr = Trainer(train_cfg, device=device)
    steps = (train_cfg.horizon * tr.n_local * tr.spec.n_robots
             // train_cfg.ppo.batch_size * train_cfg.ppo.epochs)
    want = training_launches(tr, PIPELINE_UPDATES, steps)
    want[("lidar_obs", tr.n_local * tr.spec.n_robots, "float32")] += 1
    groups = {"selection eval": ("circle", {make_results.SELECT_ARENAS * 50}),
              "eval": ("circle", {50, EVAL_ARENAS * 50})}
    if ring_12:
        groups["eval, 12-robot ring"] = ("circle_12", {12})
    paths = [(f"{name}, fine-tune", train_cfg.world,
              {k: launches.get(k, 0) for k in want})]
    for what, (world, batches) in groups.items():
        paths.append((f"{name}, {what}", world,
                      {k: v for k, v in launches.items()
                       if k[1] in batches}))
    if device.type != "cuda":
        return paths
    got = {k: launches[k] for k in want if k in launches}
    if got != want:
        raise AssertionError(f"{name}: the fine-tune launched {got}, not "
                             f"{want}")
    evals = {k for _, _, l in paths[1:] for k in l}
    if set(launches) != set(want) | evals or {
            (n, b) for n, b, _ in evals} != {
            (n, b) for n in ("lidar_obs", "twin_trunks", "env_physics")
            for _, bs in groups.values() for b in bs} or any(
                prec != "float32" for _, _, prec in evals):
        raise AssertionError(f"{name}: the evals' kernels did not run at "
                             f"their batches in float32 alone: {launches}")
    return paths


def pipeline_args(pd, root, device, *extra) -> list:
    """make_results' arguments for a run from ``pd`` into ``root``: the
    fine-tune alone, cut in depth, on ``device``."""
    return ["--from-stage", "circle_ft", "--params-dir", str(pd), "--root",
            str(root), "--circle-ft-updates", str(PIPELINE_UPDATES),
            "--select-every", "1", "--eval-steps", str(PIPELINE_EVAL_STEPS),
            "--eval-arenas", str(EVAL_ARENAS), "--no-plots", "--device",
            str(device), *extra]


def same_keys(got, want) -> bool:
    """Whether two JSON objects have the same keys, level by level."""
    if not isinstance(want, dict):
        return True
    return (isinstance(got, dict) and set(got) == set(want)
            and all(same_keys(got[k], want[k]) for k in want))


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@phase("results pipeline")
def run_pipeline(device, card: str) -> list:
    """``make_results.main`` from the fine-tune on: PIPELINE_UPDATES
    updates at full width with a selection eval after each, then the sweep
    (with the ``stage2_policy`` block, from the same weights).  Checks the
    kept params against select_score's choice over the evals it made, the
    curve, the phase record, META.json and the sweep's keys (those of the
    committed results/circle_eval.json), with the launches of each part."""
    import csv
    import math
    import shutil
    import tempfile

    import torch

    from rl_collision_avoidance_torch.examples import make_results
    from rl_collision_avoidance_torch.train import TrainConfig
    from rl_collision_avoidance_torch.utils.params import (
        jax_params_to_torch, load_jax_npz)

    committed = json.loads((ROOT / "results" / "circle_eval.json").read_text())
    real, calls = make_results.run_circle_eval, []

    def recording(policy, *args, **kwargs):  # the selection evals' inputs
        ev = real(policy, *args, **kwargs)
        if kwargs.get("n_arenas") == make_results.SELECT_ARENAS:
            calls.append(({k: v.detach().cpu().clone() for k, v in
                           policy.state_dict().items()}, ev))
        return ev

    with tempfile.TemporaryDirectory() as tmp:
        pd, root = Path(tmp) / "params", Path(tmp) / "out"
        pd.mkdir()
        shutil.copy(CIRCLE_PARAMS, pd / "stage2_params.npz")
        shutil.copy(ROOT / "results" / "META.json", pd / "META.json")
        reset_counts()
        make_results.run_circle_eval = recording
        t0 = time.perf_counter()
        try:
            meta = make_results.main(pipeline_args(pd, root, device))
        finally:
            make_results.run_circle_eval = real
        sync(device)
        wall = time.perf_counter() - t0
        launches = read_counts()
        kept = jax_params_to_torch(load_jax_npz(root / "circle_ft_params.npz"))
        with open(root / "circle_ft_circle_curve.csv") as f:
            curve = list(csv.DictReader(f))
        sweep = json.loads((root / "circle_eval.json").read_text())
        written = json.loads((root / "META.json").read_text())
    record = meta["phases"][-1]
    best, pick = -10.0, None
    for i, (_, ev) in enumerate(calls):
        if make_results.select_score(ev) > best:
            best, pick = make_results.select_score(ev), i
    for row in curve:
        print(f"results pipeline: selection curve {json.dumps(row)}",
              flush=True)
    print(f"results pipeline: kept the params after update {pick + 1} of "
          f"{len(calls)} (score {best:.4f}); phase {json.dumps(record)}; "
          f"META.json phases {[ph['stage'] for ph in written['phases']]}, "
          f"device {written['device']!r}", flush=True)
    same = pick is not None and all(torch.equal(kept[k], calls[pick][0][k])
                                    for k in kept)
    if not (len(calls) == len(curve) == PIPELINE_UPDATES and same
            and [float(r["circle_success_mean"]) for r in curve]
            == [ev["success_rate_mean"] for _, ev in calls]
            and record["circle_select_best_score"] == round(best, 4)
            and record["circle_select_every"] == 1
            and written == meta
            and [ph["stage"] for ph in meta["phases"]] == [
                "stage1", "stage2", "circle_ft"]):
        raise AssertionError(f"results pipeline: the kept params, the curve "
                             f"or the records are not select_score's choice "
                             f"over the evals made: {curve}, {record}")
    rows = {k: v for k, v in sweep.items() if isinstance(v, dict)
            and "success_rate" in v}
    if not (same_keys(sweep, committed) and all(
            0.0 <= v["success_rate"] <= 1.0
            and math.isfinite(v.get("success_rate_mean", 0.0))
            for v in rows.values())):
        raise AssertionError(f"results pipeline: the sweep's keys or values "
                             f"differ from the committed file's: "
                             f"{json.dumps(sweep)}")
    for k, v in rows.items():
        print(f"results pipeline: sweep {k}: card, {PIPELINE_EVAL_STEPS} "
              f"steps {json.dumps(v)}; committed (TPU, 3,000 steps) "
              f"{json.dumps(committed.get(k))}", flush=True)
    print(f"results pipeline: the fine-tune ({PIPELINE_UPDATES} updates, "
          f"{len(calls)} selection evals) {record['wall_s']} s, the sweep "
          f"{sweep['eval_wall_s']} s, main {wall:.2f} s wall on {device} "
          f"[{card}]; kernel launches (name, batch, precision): {launches}",
          flush=True)
    return pipeline_paths("results pipeline", launches,
                          TrainConfig.circle_ft(n_arenas=FT_ARENAS), device,
                          ring_12=True)


@phase("results pipeline, bf16")
def run_pipeline_bf16(device, card: str, obs_bf16: bool) -> list:
    """``make_results.main --bf16`` (``--obs-bf16`` with ``obs_bf16``), the
    bf16 fine-tune of ``circle_ft_bf16.py``, cut as :func:`run_pipeline`:
    its eval blocks, params, and the launches (bf16 trunks in training,
    float32 in every eval)."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from rl_collision_avoidance_torch.examples import make_results
    from rl_collision_avoidance_torch.train import TrainConfig

    name = "circle_ft_bf16" + ("" if obs_bf16 else "_f32obs")
    with tempfile.TemporaryDirectory() as tmp:
        pd, root = Path(tmp) / "params", Path(tmp) / "out"
        pd.mkdir()
        shutil.copy(CIRCLE_PARAMS, pd / "stage2_params.npz")
        reset_counts()
        t0 = time.perf_counter()
        out = make_results.main(pipeline_args(
            pd, root, device, "--bf16", *(["--obs-bf16"] if obs_bf16 else [])))
        sync(device)
        wall = time.perf_counter() - t0
        launches = read_counts()
        with np.load(root / f"{name}_params.npz") as z:
            finite = all(bool(np.isfinite(z[k]).all()) for k in z.files)
        written = json.loads((root / f"{name}_eval.json").read_text())
        files = sorted(p.name for p in root.iterdir() if p.is_file())
    blocks = {k: out[k] for k in ("deterministic", "jitter_0.3m")}
    for k, v in blocks.items():
        print(f"results pipeline ({name}): {k}: {json.dumps(v)}", flush=True)
    print(f"results pipeline ({name}): phase {json.dumps(out['phase'])}; "
          f"files {files}; main {wall:.2f} s wall [{card}]; kernel launches "
          f"(name, batch, precision): {launches}", flush=True)
    if not (finite and written == {k: v for k, v in out.items()
                                   if k != "phase"}
            and blocks["jitter_0.3m"]["n_arenas"] == EVAL_ARENAS
            and all(math.isfinite(b["success_rate"])
                    for b in blocks.values())
            and files == sorted(f"{name}_{f}" for f in (
                "circle_curve.csv", "eval.json", "metrics.csv",
                "params.npz"))):
        raise AssertionError(f"results pipeline ({name}): non-finite params, "
                             f"a malformed eval or missing files: {files}")
    cfg = TrainConfig.circle_ft(
        n_arenas=FT_ARENAS, policy_dtype=torch.bfloat16,
        obs_store_dtype=torch.bfloat16 if obs_bf16 else None)
    return pipeline_paths(f"results pipeline, {name}", launches, cfg, device,
                          ring_12=False)


@phase("mlp policy")
def check_mlp(device, card: str):
    """MLPPolicy's forward and the gradients of a mean loss on the card
    against the same module on the CPU, within MLP_ATOL (plain PyTorch: the
    JAX package's MLPPolicy has no kernel either)."""
    import copy

    import torch

    from rl_collision_avoidance_torch.models import MLPPolicy
    from rl_collision_avoidance_torch.ops import trunk_cuda

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        cpu = MLPPolicy(MLP_OBS)
    gpu = copy.deepcopy(cpu).to(device)
    obs = torch.randn((MLP_BATCH, MLP_OBS),
                      generator=torch.Generator().manual_seed(SEED))

    def run(policy, x):
        value, mean, logstd = policy(x)
        loss = value.square().mean() + mean.square().mean() + logstd.sum()
        grads = torch.autograd.grad(loss, list(policy.parameters()))
        return [value, mean, *grads]

    with trunk_cuda.exact_float32():
        (got, ms) = timed(lambda: run(gpu, obs.to(device)), device)
    want = run(cpu, obs)
    names = ["value", "mean", *(f"grad {n}" for n, _ in
                                cpu.named_parameters())]
    errs = {n: float((g.detach().cpu() - w.detach()).abs().max())
            for n, g, w in zip(names, got, want)}
    took = "" if ms is None else (f"; forward and backward {ms:.3f} ms "
                                  f"(CUDA events, first call)")
    print(f"mlp policy: B = {MLP_BATCH}, {MLP_OBS} inputs, {device} against "
          f"the CPU, max |diff| {json.dumps(errs)} (atol {MLP_ATOL}){took} "
          f"[{card}]", flush=True)
    worst = max(errs, key=errs.get)
    if not errs[worst] <= MLP_ATOL:
        raise AssertionError(f"MLPPolicy on the card differs from the CPU "
                             f"by {errs[worst]} in {worst}")


def main() -> int:
    if not (ROOT / "rl_collision_avoidance_torch").is_dir():
        print("chip_smoke.py: the rl_collision_avoidance_torch package is not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card is visible (torch.cuda."
              "is_available() is False)", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    name, label = check_device()
    device = torch.device("cuda", 0)
    build_kernels()
    check_sass()
    check_world_compiler(device, label)
    from rl_collision_avoidance_torch.examples.make_results import (
        SELECT_ARENAS)
    from rl_collision_avoidance_torch.train import TrainConfig

    # each kernel at every world and batch the paths give it
    n = {w: spec_of(w).n_robots for w in WORLD_PARAMS}
    s2 = TrainConfig.stage2(n_arenas=S2_ARENAS, seed=SEED)
    ft = TrainConfig.circle_ft(n_arenas=FT_ARENAS, seed=SEED)
    mp_arenas, mp_batch = TRAIN_ARENAS // MP_RANKS, BWD_BATCH // MP_RANKS
    checks = [check_lidar(device, "stage1", ARENAS),
              check_lidar(device, "stage1", TRAIN_ARENAS),
              check_trunk(device, "stage1", ARENAS * n["stage1"]),
              check_trunk(device, "stage1", TRAIN_ARENAS * n["stage1"]),
              check_trunk(device, "stage1", BWD_BATCH),
              check_trunk_bwd(device, "stage1", BWD_BATCH),
              check_lidar(device, "circle", 1),
              check_lidar(device, "circle", EVAL_ARENAS),
              check_trunk(device, "circle", n["circle"]),
              check_trunk(device, "circle", EVAL_ARENAS * n["circle"]),
              check_lidar(device, "stage2", S2_ARENAS),
              check_trunk(device, "stage2", S2_ARENAS * n["stage2"]),
              check_trunk(device, "stage2", s2.ppo.batch_size),
              check_trunk_bwd(device, "stage2", s2.ppo.batch_size),
              check_lidar(device, "circle_train", FT_ARENAS),
              check_trunk(device, "circle_train",
                          FT_ARENAS * n["circle_train"]),
              check_trunk(device, "circle_train", ft.ppo.batch_size),
              check_trunk_bwd(device, "circle_train", ft.ppo.batch_size),
              check_trunk(device, "stage1", ARENAS * n["stage1"], "bf16"),
              check_trunk(device, "stage1", TRAIN_ARENAS * n["stage1"],
                          "bf16"),
              check_trunk(device, "stage1", BWD_BATCH, "bf16"),
              check_trunk_bwd(device, "stage1", BWD_BATCH, "bf16"),
              check_lidar(device, "stage1_rect", TRAIN_ARENAS, discs=False),
              check_trunk(device, "stage1_rect", TRAIN_ARENAS * n["stage1"]),
              check_trunk(device, "stage1_rect", BWD_BATCH),
              check_trunk_bwd(device, "stage1_rect", BWD_BATCH),
              check_lidar(device, "circle", 1, discs=False),
              check_lidar(device, "circle", RECT_ARENAS, discs=False),
              check_trunk(device, "circle", RECT_ARENAS * n["circle"]),
              # the curriculum's jittered eval
              check_lidar(device, "circle", CURRICULUM_EVAL_ARENAS),
              # a rank's shapes in the two-rank stage-1 training
              check_lidar(device, "stage1", mp_arenas),
              *(f(device, "stage1", b, precision)
                for precision in ("float32", "bf16")
                for f, b in ((check_trunk, mp_arenas * n["stage1"]),
                             (check_trunk, mp_batch),
                             (check_trunk_bwd, mp_batch))),
              # the results pipeline: its selection eval and 12-robot ring,
              # the bf16 fine-tune on bf16 and on float32 scans; stage 2 in
              # bf16
              check_lidar(device, "circle", SELECT_ARENAS),
              check_trunk(device, "circle", SELECT_ARENAS * n["circle"]),
              check_lidar(device, "circle_12", 1),
              check_trunk(device, "circle_12", n["circle_12"]),
              check_trunk(device, "circle_train",
                          FT_ARENAS * n["circle_train"], "bf16", True),
              check_trunk(device, "circle_train", ft.ppo.batch_size, "bf16",
                          True),
              check_trunk_bwd(device, "circle_train", ft.ppo.batch_size,
                              "bf16", True),
              check_trunk(device, "stage2", S2_ARENAS * n["stage2"], "bf16"),
              check_trunk(device, "stage2", s2.ppo.batch_size, "bf16"),
              check_trunk_bwd(device, "stage2", s2.ppo.batch_size, "bf16"),
              # the env step at every world and batch of the paths
              *(r for world, arenas in (
                  ("stage1", ARENAS), ("stage1", TRAIN_ARENAS),
                  ("stage1", mp_arenas), ("stage2", S2_ARENAS),
                  ("circle_train", FT_ARENAS), ("circle", 1),
                  ("circle", EVAL_ARENAS), ("circle", SELECT_ARENAS),
                  ("circle", CURRICULUM_EVAL_ARENAS), ("circle_12", 1))
                for r in check_env(device, world, arenas))]
    pass_times(device)
    records = {(r["name"], r["world"], r["batch"], r["precision"]): r
               for r in checks}
    s1 = TrainConfig.stage1(n_arenas=TRAIN_ARENAS, seed=SEED)
    s1_bf16 = TrainConfig.stage1(n_arenas=TRAIN_ARENAS, seed=SEED,
                                 policy_dtype=torch.bfloat16,
                                 obs_store_dtype=torch.bfloat16)
    paths = [("acting", "stage1", run_slice(device, label))]
    launches, _, state, s1_metrics = phase("stage-1 training slice")(
        run_training)(device, label, s1, PARAMS, 1 + TRAIN_UPDATES, 0.5)
    s1_params = {k: v.clone() for k, v in state.policy.state_dict().items()}
    del state
    paths += [("training", "stage1", launches),
              ("acting, bf16", "stage1", run_slice(device, label, bf16=True)),
              ("training, bf16", "stage1", phase("stage-1 bf16 training")(
                  run_training)(device, label, s1_bf16, PARAMS,
                                1 + TRAIN_UPDATES, 0.5)[0])]
    # multi-process training: the slice again as one NCCL rank, then two
    # gloo ranks sharing the card
    launches, nccl_ms = run_one_rank_nccl(device, label, s1,
                                          1 + TRAIN_UPDATES, s1_params,
                                          s1_metrics)
    del s1_params
    paths.append(("training, 1 rank (NCCL)", "stage1", launches))
    two = run_two_ranks(device, label)
    paths += [("training, 2 ranks", "stage1", two["float32"]),
              ("training, 2 ranks, bf16", "stage1", two["bf16"])]
    print(f"collectives: one all-reduce of the {flat_grad_numel()}-float "
          f"gradient ({4 * flat_grad_numel()} bytes) a minibatch: NCCL, 1 "
          f"rank, {nccl_ms:.4g} ms; gloo, {MP_RANKS} ranks on CUDA tensors "
          f"of one card, {two['allreduce_ms']:.4g} ms (host clock, "
          f"synchronized) [{label}]", flush=True)
    paths += [("circle eval, 1 arena", "circle",
              run_circle(device, label, 1, 0.0)),
             (f"circle eval, {EVAL_ARENAS} arenas", "circle",
              run_circle(device, label, EVAL_ARENAS, EVAL_NOISE))]
    check_graphs(device, label)
    launches, tr, state, _ = phase("stage-2 training")(run_training)(
        device, label, s2, PARAMS, 1 + TRAIN_UPDATES, S2_MIN_GOAL)
    paths.append(("stage-2 training", "stage2", launches))
    checkpoint_round_trip(tr, state)
    del tr, state
    paths.append(("circle fine-tune", "circle_train", phase(
        "circle fine-tune")(run_training)(device, label, ft, CIRCLE_PARAMS, 1,
                                          None, f64=True)[0]))
    s2_bf16 = TrainConfig.stage2(n_arenas=S2_ARENAS, seed=SEED,
                                 policy_dtype=torch.bfloat16,
                                 obs_store_dtype=torch.bfloat16)
    paths.append(("stage-2 training, bf16", "stage2", phase(
        "stage-2 bf16 training")(run_training)(device, label, s2_bf16, PARAMS,
                                               S2_BF16_UPDATES,
                                               S2_MIN_GOAL)[0]))
    paths += run_pipeline(device, label)
    paths += run_pipeline_bf16(device, label, obs_bf16=True)
    paths += run_pipeline_bf16(device, label, obs_bf16=False)
    # the box footprint: stage1_rect training, then one acting step of its
    # state against the plain path, and the rect circle eval
    s1_rect = TrainConfig.stage1(n_arenas=TRAIN_ARENAS, seed=SEED,
                                 world="stage1_rect")
    launches, tr, state, _ = phase("stage1_rect training")(run_training)(
        device, label, s1_rect, PARAMS, 1 + TRAIN_UPDATES, 0.5)
    paths.append(("training, rect", "stage1_rect", launches))
    compare_plain_step(tr.env, state.policy, state.env_state,
                       tr.env.obs(state.env_state))
    del tr, state
    paths += [("circle eval, rect, 1 arena", "circle",
               run_circle(device, label, 1, 0.0, "rect")),
              (f"circle eval, rect culled to {RECT_CULL_K}, 1 arena",
               "circle", run_circle(device, label, 1, 0.0, "rect",
                                    RECT_CULL_K)),
              (f"circle eval, rect, {RECT_ARENAS} arenas", "circle",
               run_circle(device, label, RECT_ARENAS, RECT_NOISE, "rect"))]
    paths += run_curriculum(device, label)
    check_mlp(device, label)
    silhouettes = [time_silhouettes(device, label, "stage1_rect",
                                    TRAIN_ARENAS),
                   time_silhouettes(device, label, "circle", 1),
                   time_silhouettes(device, label, "circle", 1, RECT_CULL_K),
                   time_silhouettes(device, label, "circle", RECT_ARENAS)]
    keys = ("name", "path", "world", "batch", "precision", "route", "source",
            "replaces", "launches", "max_abs_err", "ms", "host_us",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "workspace_bytes", "peak_bytes")
    kernels = [{**records[(name, world, b, prec)], "path": path,
                "launches": k}
               for path, world, launches in paths
               for (name, b, prec), k in launches.items()]
    if {(k["name"], k["world"], k["batch"], k["precision"])
            for k in kernels} != set(records):
        raise AssertionError("a checked shape is not on a path, or a path's "
                             "shape was not checked")
    print(f"silhouettes (device ms a call, plain PyTorch): "
          f"{json.dumps(silhouettes)}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in kernels]}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["mp-rank"]:
        sys.exit(mp_rank(int(sys.argv[2]), *sys.argv[3:6]))
    sys.exit(main())
