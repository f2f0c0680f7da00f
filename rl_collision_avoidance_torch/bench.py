"""Acting benchmark of the port: stage-1 policy forward, Gaussian sample
and env step, batched over arenas, timed on the CUDA card.

Counterpart of the acting mode of ``rl_collision_avoidance_tpu/bench.py``
(its ``one_step``).  The time comes from CUDA events around a run of steps
that starts after a warm-up, and is printed with the card's name and power
limit.  ``--profile`` instead traces a short window with torch.profiler
and prints where the device time goes, by kernel, and the device's idle
share of the window.  Usage::

    python -m rl_collision_avoidance_torch.bench --arenas 128 --steps 256
    python -m rl_collision_avoidance_torch.bench --profile --steps 20
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from .engine.env import Env, EnvState, Obs
from .models import distributions
from .models.policy import CNNPolicy, load_policy
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


def _warm_start(arenas, warmup, world, params, seed):
    """Env, policy and sampler on the card, after ``warmup`` acting steps."""
    spec = get_world(world)
    env = Env(spec, seed=seed)
    policy = load_policy(params, device=env.device, frames=spec.laser_frames,
                         beams=spec.n_beams)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed + 1)
    state, obs = env.reset(arenas)
    state, obs, _ = run_acting(env, policy, state, obs, warmup, gen)
    return env, policy, gen, state, obs


def measure(arenas: int = 128, steps: int = 256, warmup: int = 16,
            world: str = "stage1", params: str = DEFAULT_PARAMS,
            seed: int = 0) -> dict:
    """Robot-steps/s of the acting loop on the CUDA card."""
    env, policy, gen, state, obs = _warm_start(arenas, warmup, world, params,
                                               seed)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, obs, stats = run_acting(env, policy, state, obs, steps, gen)
    end.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    robots = arenas * env.n_robots
    return {"metric": "acting robot-steps/s", "world": world,
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
            seed: int = 0) -> dict:
    """Device time by kernel over ``steps`` acting steps (torch.profiler),
    and the device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    env, policy, gen, state, obs = _warm_start(arenas, warmup, world, params,
                                               seed)
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
    return {"world": world, "arenas": arenas, "steps": steps,
            "ms_per_step": window_ms / steps,
            "device_ms_per_step": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / window_ms,
            "device_ops_per_step": launches / steps,
            "top_ms_per_step": {k[:80]: v / steps for k, v in ranked[:12]},
            "device": torch.cuda.get_device_name(env.device),
            "card": card_label()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arenas", type=int, default=128)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--warmup", type=int, default=16)
    ap.add_argument("--world", default="stage1")
    ap.add_argument("--params", default=DEFAULT_PARAMS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the window and report device time by kernel")
    args = ap.parse_args(argv)
    run = profile if args.profile else measure
    print(json.dumps(run(args.arenas, args.steps, args.warmup, args.world,
                         args.params, args.seed)))


if __name__ == "__main__":
    main()
