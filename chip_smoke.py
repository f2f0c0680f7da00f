"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernels, holds each against its plain PyTorch version
on the card, then drives the stage-1 acting path (policy forward -> Gaussian
sample -> env step, 128 arenas x 24 robots, the committed trained weights)
and checks that it ran through the kernels and stayed right.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  Exits non-zero, with no
result line, when there is no card or when the port is not beside it.  Its
last three lines are the per-kernel JSON record, the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PARAMS = ROOT / "results" / "stage1_params.npz"
ARENAS = 128          # the JAX bench's accelerator default: 3,072 robots
SLICE_STEPS = 256     # timed acting steps (after WARMUP_STEPS)
WARMUP_STEPS = 8
SEED = 0
LIDAR_ATOL = 1e-5     # normalized obs, as tests/test_pallas.py holds the TPU kernel
# The trunk kernel sums its 4096-long fc1 dot products (and the 96- and
# 15-long conv sums) in another order than cuBLAS/cuDNN; the rounding error
# of such a sum is ~sqrt(n) * 2^-24 * sum|terms| ~ 1e-5 at these weights, so
# 1e-4 absolute plus 1e-4 relative leaves room without hiding a wrong
# weight, tap or layout (those give errors of order 1).
TRUNK_ATOL = TRUNK_RTOL = 1e-4
POLICY_ATOL = 1e-4    # actions and values through the trunk features
# Published H100 SXM peaks (NVIDIA data sheet): HBM and non-tensor float32.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms for moving ``nbytes`` and doing ``ops`` f32 ops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


@phase("lidar kernel vs plain")
def check_lidar(device):
    import torch

    from rl_collision_avoidance_torch.engine.celltable import lookup_cells
    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.ops import lidar_cuda
    from rl_collision_avoidance_torch.worlds import stage1

    spec = stage1()
    env = Env(spec, device=device, seed=SEED)
    t = env.lidar_table
    pose = stage1_test_poses(env, ARENAS)
    args = (env._lidar_cells, t.lo, t.cell, t.shape, env.local_dirs,
            spec.robot_radius, spec.max_range)
    got = lidar_cuda.lidar_obs(pose, *args)
    want = lidar_cuda.lidar_obs_plain(pose, *args)
    err = float((got - want).abs().max())
    if device.type == "cuda":
        torch.cuda.synchronize()  # a fault inside the kernel surfaces here
    if not (err <= LIDAR_ATOL and torch.isfinite(got).all()):
        raise AssertionError(f"lidar kernel differs from its plain version "
                             f"by {err} > {LIDAR_ATOL}")
    near = got[:, 0].amin(dim=-1) < 0.5 / spec.max_range - 0.5
    hit_wall = float(near.float().mean())
    print(f"lidar: max |kernel - plain| = {err:.3g} on {tuple(got.shape)} "
          f"(atol {LIDAR_ATOL}); share of near-wall robots with a beam "
          f"under 0.5 m: {hit_wall:.2f}", flush=True)

    a, n, beams = got.shape
    cells = lookup_cells(t.lo, t.cell, t.shape, pose[..., :2])
    cand = int(torch.as_tensor(t.counts, device=device)[cells].sum())
    # per (robot, beam): rotation 6, final min + normalize 4; per valid
    # candidate segment 12; per other robot's disc 11 (see csrc/lidar.cu)
    ops = beams * (a * n * (6 + 4 + 11 * (n - 1)) + 12 * cand)
    nbytes = 4 * (pose.numel() + t.table.size + env.local_dirs.numel()
                  + got.numel())
    record = {"name": "lidar_obs", "route": "cuda",
              "source": "rl_collision_avoidance_torch/ops/csrc/lidar.cu",
              "replaces": "rl_collision_avoidance_tpu/ops/lidar_pallas.py:35",
              "max_abs_err": err, "library_ms": None}
    if device.type == "cuda":
        record["ms"] = time_ms(lambda: lidar_cuda.lidar_obs(pose, *args), 50)
        record["plain_ms"] = time_ms(
            lambda: lidar_cuda.lidar_obs_plain(pose, *args), 10)
    record["bound_ms"], record["bound_by"] = bound(nbytes, ops)
    return record


@phase("trunk kernel vs plain")
def check_trunk(device):
    import torch
    import torch.nn.functional as F

    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.models import load_policy
    from rl_collision_avoidance_torch.ops import trunk_cuda
    from rl_collision_avoidance_torch.worlds import stage1

    spec = stage1()
    policy = load_policy(PARAMS, device=device)
    env = Env(spec, device=device, seed=SEED + 1)
    _, obs = env.reset(ARENAS)
    scans = obs.scans.reshape(-1, spec.laser_frames, spec.n_beams)
    act, crt = policy.trunk_weights("act"), policy.trunk_weights("crt")
    with torch.no_grad():
        got = trunk_cuda.twin_trunks(scans, act, crt)
        want = trunk_cuda.twin_trunks_plain(scans, act, crt)
    err = float((got - want).abs().max())
    if device.type == "cuda":
        torch.cuda.synchronize()
    limit = (TRUNK_ATOL + TRUNK_RTOL * want.abs()).sub((got - want).abs())
    if not (bool((limit >= 0).all()) and torch.isfinite(got).all()):
        raise AssertionError(f"trunk kernel differs from its plain version "
                             f"by {err} (atol {TRUNK_ATOL}, rtol "
                             f"{TRUNK_RTOL})")
    b, frames, beams = scans.shape
    print(f"trunk: max |kernel - plain| = {err:.3g} on B = {b} (tile 10, so "
          f"the last block is ragged), features up to "
          f"{float(want.abs().max()):.3g}", flush=True)

    l1 = (beams - 3) // 2 + 1
    l2 = (l1 - 1) // 2 + 1
    taps1 = sum(1 for l in range(l1) for k in range(5)
                if 0 <= 2 * l + k - 1 < beams)
    taps2 = sum(1 for m in range(l2) for k in range(3)
                if 0 <= 2 * m + k - 1 < l1)
    per_sample = (2 * 32 * frames * taps1 + 2 * 32 * 32 * taps2
                  + 2 * 256 * 32 * l2 + 2 * 32 * (l1 + l2) + 2 * 256)
    ops = 2 * b * per_sample              # two trunks; FMA = 2 ops
    nbytes = 4 * (scans.numel() + sum(w.numel() for w in (*act, *crt))
                  + got.numel())
    record = {"name": "twin_trunks", "route": "cuda",
              "source": "rl_collision_avoidance_torch/ops/csrc/trunk_fwd.cu",
              "replaces": "rl_collision_avoidance_tpu/ops/trunk_pallas.py:147",
              "max_abs_err": err}

    def library():  # the bare cuDNN / cuBLAS calls, exact float32
        with trunk_cuda.exact_float32():
            for w1, b1, w2, b2, wf, bf in (act, crt):
                y = F.relu(F.conv1d(scans, w1, b1, stride=2, padding=1))
                y = F.relu(F.conv1d(y, w2, b2, stride=2, padding=1))
                F.relu(F.linear(y.flatten(1), wf, bf))

    if device.type == "cuda":
        with torch.no_grad():
            record["ms"] = time_ms(
                lambda: trunk_cuda.twin_trunks(scans, act, crt), 20)
            record["plain_ms"] = time_ms(
                lambda: trunk_cuda.twin_trunks_plain(scans, act, crt), 20)
            record["library_ms"] = time_ms(library, 20)
    record["bound_ms"], record["bound_by"] = bound(nbytes, ops)
    return record


@phase("stage-1 acting slice")
def run_slice(device, card: str):
    import torch

    from rl_collision_avoidance_torch import bench
    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.models import load_policy
    from rl_collision_avoidance_torch.ops import lidar_cuda, trunk_cuda
    from rl_collision_avoidance_torch.worlds import stage1

    spec = stage1()
    policy = load_policy(PARAMS, device=device)
    env = Env(spec, device=device, seed=SEED)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)

    lidar_cuda.launches = trunk_cuda.launches = 0
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
    launches = {"lidar_obs": lidar_cuda.launches,
                "twin_trunks": trunk_cuda.launches}

    robots = ARENAS * spec.n_robots
    ends = (warm["ends"] + stats["ends"]).tolist()
    goal, crash, timeout = ends[1:]
    finite = bool(warm["finite"] & stats["finite"])
    print(f"slice: {WARMUP_STEPS} + {SLICE_STEPS} steps of {ARENAS} arenas "
          f"x {spec.n_robots} robots; episode ends goal {goal} crash {crash} "
          f"timeout {timeout}; kernel launches {launches}", flush=True)
    if on_card:
        seconds = start.elapsed_time(end) / 1e3
        print(f"slice: {robots * SLICE_STEPS / seconds:.1f} robot-steps/s "
              f"({seconds * 1e3 / SLICE_STEPS:.3f} ms/step, CUDA events) on "
              f"{torch.cuda.get_device_name(device)} [{card}]", flush=True)
    if not finite:
        raise AssertionError("non-finite reward or observation in the slice")
    if on_card and not all(launches.values()):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    ended = goal + crash + timeout
    if ended == 0 or goal / ended < 0.5:
        raise AssertionError(f"the trained stage-1 policy reached the goal in "
                             f"{goal} of {ended} episodes (< 50%)")
    print(f"slice: goal share {goal / ended:.3f} of {ended} ended episodes "
          f"(the JAX training run's stage-1 plateau is ~0.85)", flush=True)
    compare_plain_step(env, policy, state, obs)
    return launches


def compare_plain_step(env, policy, state, obs):
    """One more step of the slice's state through the plain path (plain trunk
    + the env with use_kernels=False) against the kernel path, with the same
    noise and reset draws.  Both envs step with the kernel path's action, so
    the lidar comparison sees identical poses."""
    import torch

    from rl_collision_avoidance_torch import bench
    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.ops.trunk_cuda import twin_trunks_plain

    plain_env = Env(env.spec, device=env.device, use_kernels=False)
    a, n = obs.scans.shape[:2]
    noise = torch.randn((a * n, 2), generator=env.generator,
                        device=env.device)
    rp, rg = env.sample_pose_goal(a)
    action, s_k, o_k, r_k, d_k, _ = bench.act_step(env, policy, state, obs,
                                                   noise, None, rp, rg)
    with torch.no_grad():
        feats = twin_trunks_plain(obs.scans.reshape(a * n, *obs.scans.shape[2:]),
                                  policy.trunk_weights("act"),
                                  policy.trunk_weights("crt"))
        _, mean, logstd = policy.heads(feats, obs.goal.reshape(a * n, 2),
                                       obs.speed.reshape(a * n, 2))
        plain_action = (mean + torch.exp(logstd) * noise).reshape(a, n, 2)
    s_p, o_p, r_p, d_p, _ = plain_env.step(state, action, rp, rg)
    errs = {"action": float((action - plain_action).abs().max()),
            "reward": float((r_k - r_p).abs().max()),
            "scans": float((o_k.scans - o_p.scans).abs().max()),
            "pose": float((s_k.pose - s_p.pose).abs().max())}
    print(f"plain-path step: max |kernel path - plain path| {errs}; done "
          f"agrees: {bool((d_k == d_p).all())}", flush=True)
    if not (errs["action"] <= POLICY_ATOL and errs["reward"] == 0.0
            and errs["pose"] == 0.0 and errs["scans"] <= LIDAR_ATOL
            and bool((d_k == d_p).all())):
        raise AssertionError(f"the kernel path left the plain path: {errs}")


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
    kernels = [check_lidar(device), check_trunk(device)]
    launches = run_slice(device, label)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in kernels]}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
