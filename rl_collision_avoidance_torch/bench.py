"""Benchmarks of the port on the CUDA card: acting (policy forward,
Gaussian sample and env step, batched over arenas) and, with ``--train``,
training updates under the world's preset (stage 1; ``--world stage2``,
``--world circle_train`` for stage 2 and the circle fine-tune).

Counterparts of the acting mode of ``rl_collision_avoidance_tpu/bench.py``
(its ``one_step``) and of its ``measure_training``.  Times come from CUDA
events around work that starts after a warm-up, and are printed with the
card's name and power limit.  ``--profile`` instead traces a window with
torch.profiler and prints where the device time goes and the device's idle
share of the window: by kernel for acting, by phase of the update (rollout,
GAE, PPO forward, trunk backward kernel, the rest of autograd, Adam) for
training.  ``--bf16`` runs the policy in bf16 (the trunk kernels' bf16
mode) and ``--obs-bf16`` stores the scans in bf16, as the JAX bench's
flags do; ``--f32`` forces both off.  Unlike the JAX acting bench, whose
default is bf16, both modes here default to float32.  ``--footprint rect``
runs the acting bench with Stage's exact box footprint (collision and lidar
silhouettes) and ``--disc-cull K`` culls the silhouettes to each robot's K
nearest, as the JAX bench's flags do; ``--train --world stage1_rect``
trains on the box footprint.  ``--scaling N`` is the counterpart of the
JAX bench's CPU scaling proof (``measure_scaling``): the acting rate of 1
and of N gloo processes on the CPU, on mini, one thread each.  Usage::

    python -m rl_collision_avoidance_torch.bench --arenas 128 --steps 256
    python -m rl_collision_avoidance_torch.bench --bf16 --obs-bf16
    python -m rl_collision_avoidance_torch.bench --profile --steps 20
    python -m rl_collision_avoidance_torch.bench --train [--profile] --arenas 32
    python -m rl_collision_avoidance_torch.bench --train --profile \
        --world stage2 --arenas 16
    python -m rl_collision_avoidance_torch.bench [--profile] --footprint rect
    python -m rl_collision_avoidance_torch.bench --train --world stage1_rect
    python -m rl_collision_avoidance_torch.bench --scaling 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from .engine.env import Env, EnvState, Obs
from .models import distributions
from .models.policy import CNNPolicy, load_policy
from .train import TrainConfig, Trainer
from .utils.device import card_label
from .worlds import get_world

DEFAULT_PARAMS = str(Path(__file__).resolve().parents[1] / "results"
                     / "stage1_params.npz")


def act_step(env: Env, policy: CNNPolicy, state: EnvState, obs: Obs,
             noise: torch.Tensor | None = None,
             generator: torch.Generator | None = None,
             reset_pose: torch.Tensor | None = None,
             reset_goal: torch.Tensor | None = None):
    """One acting step: policy forward on every robot, a Gaussian sample
    (from ``noise`` (A*N, 2) or ``generator``), then ``env.step``.
    Returns (action (A, N, 2), state', obs', reward, done, info)."""
    a, n = obs.scans.shape[:2]
    flat = lambda x: x.reshape(a * n, *x.shape[2:])
    with torch.no_grad():
        _, mean, logstd = policy(flat(obs.scans), flat(obs.goal),
                                 flat(obs.speed))
        action = distributions.sample(mean, logstd, noise, generator)
    action = action.reshape(a, n, 2)
    return (action, *env.step(state, action, reset_pose, reset_goal))


def run_acting(env: Env, policy: CNNPolicy, state: EnvState, obs: Obs,
               steps: int, generator: torch.Generator):
    """``steps`` acting steps.  Returns (state, obs, stats): stats holds the
    per-result-code episode-end counts (a (4,) tensor, index = RESULT_*),
    the summed reward, and whether every reward and observation stayed
    finite."""
    ends = torch.zeros(4, dtype=torch.int64, device=env.device)
    reward_sum = torch.zeros((), device=env.device)
    finite = torch.ones((), dtype=torch.bool, device=env.device)
    for _ in range(steps):
        _, state, obs, reward, _, info = act_step(env, policy, state, obs,
                                                  generator=generator)
        ends += torch.bincount(info.result.flatten(), minlength=4)
        reward_sum += reward.sum()
        finite &= torch.isfinite(reward).all() & torch.isfinite(obs.scans).all()
    return state, obs, {"ends": ends, "reward_sum": reward_sum,
                        "finite": finite}


def _mode(policy_dtype, obs_dtype, footprint=None, disc_cull_k=None) -> dict:
    out = {"policy_dtype": str(policy_dtype).removeprefix("torch."),
           "obs_dtype": str(obs_dtype or torch.float32).removeprefix(
               "torch.")}
    if footprint is not None:
        out["footprint"] = footprint
    if disc_cull_k is not None:
        out["disc_cull_k"] = disc_cull_k
    return out


def _warm_start(arenas, warmup, world, params, seed, policy_dtype,
                obs_dtype, footprint=None, disc_cull_k=None):
    """Env, policy and sampler on the card, after ``warmup`` acting steps;
    ``footprint`` overrides the world's."""
    spec = get_world(world)
    if footprint is not None:
        spec = dataclasses.replace(spec, footprint=footprint)
    env = Env(spec, seed=seed, obs_dtype=obs_dtype, disc_cull_k=disc_cull_k)
    policy = load_policy(params, device=env.device, frames=spec.laser_frames,
                         beams=spec.n_beams, dtype=policy_dtype)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed + 1)
    state, obs = env.reset(arenas)
    state, obs, _ = run_acting(env, policy, state, obs, warmup, gen)
    return env, policy, gen, state, obs


def measure(arenas: int = 128, steps: int = 256, warmup: int = 16,
            world: str = "stage1", params: str = DEFAULT_PARAMS,
            seed: int = 0, policy_dtype: torch.dtype = torch.float32,
            obs_dtype: torch.dtype | None = None, footprint: str | None = None,
            disc_cull_k: int | None = None) -> dict:
    """Robot-steps/s of the acting loop on the CUDA card."""
    env, policy, gen, state, obs = _warm_start(arenas, warmup, world, params,
                                               seed, policy_dtype, obs_dtype,
                                               footprint, disc_cull_k)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, obs, stats = run_acting(env, policy, state, obs, steps, gen)
    end.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    robots = arenas * env.n_robots
    return {"metric": "acting robot-steps/s", "world": world,
            **_mode(policy_dtype, obs_dtype, footprint, disc_cull_k),
            "arenas": arenas, "robots": robots, "steps": steps,
            "value": robots * steps / seconds,
            "ms_per_step": seconds * 1e3 / steps,
            "episode_ends": dict(zip(("running", "goal", "crash", "timeout"),
                                     stats["ends"].tolist())),
            "finite": bool(stats["finite"]),
            "device": torch.cuda.get_device_name(env.device),
            "card": card_label()}


def profile(arenas: int = 128, steps: int = 20, warmup: int = 16,
            world: str = "stage1", params: str = DEFAULT_PARAMS,
            seed: int = 0, policy_dtype: torch.dtype = torch.float32,
            obs_dtype: torch.dtype | None = None, footprint: str | None = None,
            disc_cull_k: int | None = None) -> dict:
    """Device time by kernel over ``steps`` acting steps (torch.profiler),
    and the device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    env, policy, gen, state, obs = _warm_start(arenas, warmup, world, params,
                                               seed, policy_dtype, obs_dtype,
                                               footprint, disc_cull_k)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        start.record()
        run_acting(env, policy, state, obs, steps, gen)
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    kernels, launches = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
            launches += 1
    busy_ms = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"world": world,
            **_mode(policy_dtype, obs_dtype, footprint, disc_cull_k),
            "arenas": arenas, "steps": steps,
            "ms_per_step": window_ms / steps,
            "device_ms_per_step": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / window_ms,
            "device_ops_per_step": launches / steps,
            "top_ms_per_step": {k[:80]: v / steps for k, v in ranked[:12]},
            "device": torch.cuda.get_device_name(env.device),
            "card": card_label()}


def _trainer(arenas: int, world: str, seed: int, policy_dtype, obs_dtype):
    """A trainer on the card with the world's preset
    (``TrainConfig.for_world``) and its state after one warm-up update
    (random init, as the JAX package's ``measure_training``)."""
    trainer = Trainer(TrainConfig.for_world(
        world, n_arenas=arenas, seed=seed, policy_dtype=policy_dtype,
        obs_store_dtype=obs_dtype))
    state, _ = trainer.train_step(trainer.init_state())
    return trainer, state


def measure_training(arenas: int = 32, repeats: int = 3,
                     world: str = "stage1", seed: int = 0,
                     policy_dtype: torch.dtype = torch.float32,
                     obs_dtype: torch.dtype | None = None) -> dict:
    """Training robot-steps/s: the best of ``repeats`` updates (rollout +
    GAE + PPO), each timed with CUDA events."""
    trainer, state = _trainer(arenas, world, seed, policy_dtype, obs_dtype)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(repeats):
        start.record()
        state, metrics = trainer.train_step(state)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    steps = metrics["env_steps"]
    return {"metric": "training_steps_per_s", "world": world,
            **_mode(policy_dtype, obs_dtype),
            "value": steps / min(times) * 1e3, "unit": "robot-steps/s",
            "arenas": arenas, "env_steps_per_update": steps,
            "update_ms": times, "device": torch.cuda.get_device_name(),
            "card": card_label()}


#: Phases of an update, as marked by record_function in train/trainer.py,
#: algo/ppo.py and ops/trunk_cuda.py (TwinTrunks.backward).  The rest of the
#: backward runs on the autograd engine's threads, outside every range.
TRAIN_PHASES = ("rollout", "gae", "ppo_forward", "twin_trunks_grads", "adam")


def profile_training(arenas: int = 32, world: str = "stage1",
                     seed: int = 0, policy_dtype: torch.dtype = torch.float32,
                     obs_dtype: torch.dtype | None = None) -> dict:
    """Device ms of one traced update by phase, and the device's idle share
    of the update's wall time.

    The trace holds each phase range twice: on the host, and on the device
    as the span from the first to the last operation it launched.  All work
    runs on one stream in launch order, so a device operation belongs to the
    innermost phase span that contains its start; one inside none is the
    rest of autograd (``autograd_other``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    trainer, state = _trainer(arenas, world, seed, policy_dtype, obs_dtype)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        start.record()
        trainer.train_step(state)
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in device if e.name in TRAIN_PHASES),
                   key=lambda s: s[1] - s[0])
    ops = [e for e in device if e.name not in TRAIN_PHASES]
    phases = dict.fromkeys((*TRAIN_PHASES, "autograd_other"), 0.0)
    kernels = {}
    for e in ops:
        t0, ms = e.time_range.start, e.time_range.elapsed_us() / 1e3
        phase = next((name for lo, hi, name in spans if lo <= t0 <= hi),
                     "autograd_other")
        phases[phase] += ms
        key = f"{phase}: {e.name[:70]}"
        total, count = kernels.get(key, (0.0, 0))
        kernels[key] = (total + ms, count + 1)
    busy_ms = sum(phases.values())
    return {"world": world, **_mode(policy_dtype, obs_dtype),
            "arenas": arenas, "update_ms": window_ms,
            "device_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / window_ms,
            "phase_device_ms": phases, "device_ops": len(ops),
            "top_kernels_ms_launches": dict(sorted(
                kernels.items(), key=lambda kv: -kv[1][0])[:12]),
            "device": torch.cuda.get_device_name(), "card": card_label()}


def scaling_rank(world: int, rank: int, init_url: str, arenas: int,
                 steps: int, warmup: int) -> None:
    """One of ``world`` CPU processes of :func:`measure_scaling`, joined by
    gloo through ``init_url``: ``arenas`` mini arenas acted on by a random
    policy, one thread; rank 0 prints ``RATE`` and the robot-steps/s of all
    ranks together, from the first barrier after the warm-up to the
    all-reduce after the timed steps."""
    from torch import distributed

    from .parallel import (all_reduce_sum, rank_seed, setup_distributed,
                           teardown)

    torch.set_num_threads(1)
    if world > 1:
        setup_distributed(init_url, world, rank, device="cpu")
    try:
        spec = get_world("mini")
        env = Env(spec, device="cpu", seed=rank_seed(0))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            policy = CNNPolicy(spec.laser_frames, spec.n_beams).eval()
        gen = torch.Generator().manual_seed(rank_seed(1))
        state, obs = env.reset(arenas)
        state, obs, _ = run_acting(env, policy, state, obs, warmup, gen)
        if world > 1:
            distributed.barrier()
        t0 = time.perf_counter()
        _, _, stats = run_acting(env, policy, state, obs, steps, gen)
        finite = all_reduce_sum(stats["finite"].float())
        seconds = time.perf_counter() - t0
        if int(finite) != world:
            raise RuntimeError("non-finite reward or observation")
        if rank == 0:
            print("RATE", world * arenas * spec.n_robots * steps / seconds,
                  flush=True)
    finally:
        teardown()


def measure_scaling(n: int, arenas: int = 4, steps: int = 256,
                    warmup: int = 16) -> dict:
    """Acting robot-steps/s of 1 and of ``n`` CPU processes (``arenas``
    mini arenas each, so the work grows with the processes), each a
    subprocess running :func:`scaling_rank`, and the efficiency
    r_n / (n r_1).  A CPU measurement: the point is that the sharded
    program runs and scales; processes beyond the host's cores share
    them."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(root),
                                          os.environ.get("PYTHONPATH", "")])}
    rates = {}
    for world in (1, n):
        with tempfile.TemporaryDirectory() as tmp:
            code = [f"from rl_collision_avoidance_torch.bench import "
                    f"scaling_rank; scaling_rank({world}, {r}, "
                    f"'file://{tmp}/store', {arenas}, {steps}, {warmup})"
                    for r in range(world)]
            procs = [subprocess.Popen([sys.executable, "-c", c], env=env,
                                      cwd=root, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for c in code]
            try:
                logs = [p.communicate(timeout=600)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"a scaling process failed:\n{log[-2000:]}")
        rates[world] = float(next(line.split()[1] for line in
                                  logs[0].splitlines()
                                  if line.startswith("RATE")))
    r1, rn = rates[1], rates[n]
    return {"metric": f"cpu_scaling_efficiency_{n}proc",
            "value": rn / (n * r1), "unit": "fraction",
            "steps_per_s_1proc": r1, f"steps_per_s_{n}proc": rn,
            "world": "mini", "arenas_per_process": arenas, "steps": steps,
            "device": "cpu", "cpu_cores": os.cpu_count()}


def precision(args) -> tuple[torch.dtype, torch.dtype | None]:
    """(policy dtype, obs dtype) of the parsed flags: float32 and None
    unless ``--bf16`` / ``--obs-bf16``; ``--f32`` forces both off."""
    bf16 = args.bf16 and not args.f32
    obs_bf16 = args.obs_bf16 and not args.f32
    return (torch.bfloat16 if bf16 else torch.float32,
            torch.bfloat16 if obs_bf16 else None)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arenas", type=int, default=None,
                    help="arenas (default 128 acting, 32 training)")
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--warmup", type=int, default=16)
    ap.add_argument("--world", default="stage1")
    ap.add_argument("--params", default=DEFAULT_PARAMS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the window and report device time by kernel "
                         "(acting) or by phase (--train)")
    ap.add_argument("--train", action="store_true",
                    help="time training updates (random init, the "
                         "world's preset) instead of acting; --arenas "
                         "defaults to 32")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed updates with --train (the best is reported)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 policy activations and products (the "
                         "trunk kernels' bf16 mode); float32 params")
    ap.add_argument("--obs-bf16", action="store_true",
                    help="store the lidar frames as bfloat16 (acting: the "
                         "env's scan history; training: also the rollout "
                         "buffer)")
    ap.add_argument("--f32", action="store_true",
                    help="force the float32 configuration (the default)")
    ap.add_argument("--footprint", choices=["disc", "rect"], default=None,
                    help="acting: override the world's footprint (rect = "
                         "Stage's exact 0.44 x 0.38 m box for collision and "
                         "lidar silhouettes)")
    ap.add_argument("--disc-cull", type=int, default=None, metavar="K",
                    help="acting: opt-in approximate silhouette culling "
                         "(each robot's beams test its K nearest other "
                         "robots; not the exact configuration)")
    ap.add_argument("--scaling", type=int, default=None, metavar="N",
                    help="CPU scaling proof: acting robot-steps/s of 1 and "
                         "N gloo processes on mini (--arenas a process, "
                         "default 4; --steps, --warmup)")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.scaling:
        unused = [f"--{k.replace('_', '-')}" for k in (
            "train", "world", "params", "seed", "profile", "repeats", "bf16",
            "obs_bf16", "f32", "footprint", "disc_cull")
            if getattr(args, k) != ap.get_default(k)]
        if unused:
            ap.error(f"--scaling measures random-policy acting on mini in "
                     f"float32; it takes --arenas, --steps and --warmup "
                     f"only, not {' '.join(unused)}")
        print(json.dumps(measure_scaling(args.scaling, args.arenas or 4,
                                         args.steps, args.warmup)))
        return
    dtypes = precision(args)
    if args.train and (args.footprint or args.disc_cull is not None):
        ap.error("--footprint and --disc-cull set the acting bench; train "
                 "on the box footprint with --world stage1_rect")
    if args.train:
        arenas = args.arenas or 32
        out = (profile_training(arenas, args.world, args.seed, *dtypes)
               if args.profile
               else measure_training(arenas, args.repeats, args.world,
                                     args.seed, *dtypes))
        print(out.pop("card"))
    else:
        run = profile if args.profile else measure
        out = run(args.arenas or 128, args.steps, args.warmup, args.world,
                  args.params, args.seed, *dtypes, args.footprint,
                  args.disc_cull)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
