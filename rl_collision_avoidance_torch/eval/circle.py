"""The 50-robot circle-swap evaluation and its metrics.

Counterpart of ``rl_collision_avoidance_tpu/eval/circle.py``.  Every robot
acts with the policy's mean action, clipped, with no sampling
(``model/ppo.py:84-107``); a finished robot stops translating but keeps
steering (the ``circle`` world's ``FIXED_TABLES`` mode, ``circle_test.py:
64-66``).  The first result of each robot (goal, crash or timeout) and its
step are kept, and the metrics follow from them: success rate, collisions,
unfinished robots, mean travel and extra time.

With ``n_arenas > 1`` and ``pose_noise > 0`` the scenario is replicated with
initial x/y jittered by uniform +-``pose_noise`` per robot, a robustness
study with mean and std over arenas; arena 0 is never perturbed, so the
headline numbers stay those of the deterministic scenario.  A finished
robot never changes its first result, so the step loop ends as soon as
every robot has one: the metrics are those of all ``max_steps`` steps.
"""
from __future__ import annotations

import numpy as np
import torch

from ..engine.env import RESULT_CRASH, RESULT_GOAL, Env
from ..utils.profiling import span
from ..worlds import circle as circle_world

#: Steps between the loop's checks whether every robot has finished.
CHECK_EVERY = 50


def pose_noise_draw(n_arenas: int, n_robots: int, pose_noise: float,
                    generator: torch.Generator) -> torch.Tensor:
    """(A, N, 2) uniform +-``pose_noise`` offsets of the start x/y."""
    u = torch.rand((n_arenas, n_robots, 2), generator=generator,
                   device=generator.device)
    return pose_noise * (2.0 * u - 1.0)


def run_episodes(policy, env: Env, n_arenas: int, max_steps: int,
                 noise: torch.Tensor | None = None):
    """Run the scenario in ``n_arenas`` arenas for up to ``max_steps`` steps
    of mean actions; ``noise`` (A, N, 2) offsets the start x/y (arena 0's
    are ignored).  Returns (done_step, first_result, start_dist), each
    (A, N) on the env's device."""
    a, n = n_arenas, env.n_robots
    state, obs = env.reset(a)
    if noise is not None:
        noise = noise.clone()
        noise[0] = 0.0                 # arena 0 stays the reference scenario
        pose = state.pose.clone()
        pose[..., :2] += noise
        state = env.teleport(state, pose)
        first = env.scan_obs(pose)
        state.scan_hist = first[:, :, None, :].repeat(1, 1, env.frames, 1)
        obs = env.obs(state)
    start_dist = torch.linalg.vector_norm(state.goal - state.pose[..., :2],
                                          dim=-1)
    done_step = torch.zeros((a, n), dtype=torch.int32, device=env.device)
    first_result = torch.zeros_like(done_step)
    flat = lambda x: x.reshape(a * n, *x.shape[2:])
    with torch.no_grad():
        for i in range(max_steps):
            with span("act_step"):
                with span("act_policy"):
                    _, mean, _ = policy(flat(obs.scans), flat(obs.goal),
                                        flat(obs.speed))
                action = torch.stack([mean[:, 0].clamp(0.0, 1.0),
                                      mean[:, 1].clamp(-1.0, 1.0)],
                                     dim=-1).reshape(a, n, 2)
                state, obs, _, _, info = env.step(state, action)
                newly = (info.result != 0) & (first_result == 0)
                first_result = torch.where(newly,
                                           info.result.to(torch.int32),
                                           first_result)
                done_step = torch.where(newly, i + 1, done_step)
            if (i + 1) % CHECK_EVERY == 0:
                with span("eval_check"):
                    finished = bool((first_result != 0).all())
                if finished:
                    break
    return done_step, first_result, start_dist


def circle_metrics(spec, done_step, first_result, start_dist, pose_noise,
                   max_steps) -> dict:
    """The JAX package's metrics dict from (A, N) numpy results; a mean over
    no successful robot is None (JSON null)."""
    success = first_result == RESULT_GOAL                     # (A, N)
    crashed = first_result == RESULT_CRASH
    unfinished = first_result == 0
    travel_time = done_step * spec.dt * spec.substeps
    extra = travel_time - start_dist / 1.0                    # v_max = 1 m/s
    n_arenas = success.shape[0]

    def mean_extra(i):
        m = success[i]
        return float(extra[i][m].mean()) if m.any() else None

    per_arena_succ = success.mean(axis=1)
    per_arena_extra = np.array(
        [x if x is not None else np.nan
         for x in (mean_extra(i) for i in range(n_arenas))], np.float64)
    out = {
        "n_robots": int(success.shape[1]),
        "n_arenas": int(n_arenas),
        "pose_noise_m": float(pose_noise),
        "max_steps": int(max_steps),
        # headline (deterministic reference scenario = arena 0)
        "success_rate": float(per_arena_succ[0]),
        "collisions": int(crashed[0].sum()),
        "unfinished": int(unfinished[0].sum()),
        "mean_travel_time_s": (float(travel_time[0][success[0]].mean())
                               if success[0].any() else None),
        "mean_extra_time_s": mean_extra(0),
    }
    if n_arenas > 1:
        any_extra = np.any(~np.isnan(per_arena_extra))
        out.update({
            "success_rate_mean": float(per_arena_succ.mean()),
            "success_rate_std": float(per_arena_succ.std()),
            "collisions_mean": float(crashed.sum(axis=1).mean()),
            "mean_extra_time_mean": (float(np.nanmean(per_arena_extra))
                                     if any_extra else None),
            "mean_extra_time_std": (float(np.nanstd(per_arena_extra))
                                    if any_extra else None),
        })
    return out


def run_circle_eval(policy, spec=None, max_steps: int = 2000, seed: int = 0,
                    n_arenas: int = 1, pose_noise: float = 0.0,
                    noise: torch.Tensor | None = None,
                    env_kwargs: dict | None = None) -> dict:
    """Success rate, collision count, mean (extra) travel time of the port's
    ``policy`` (a ``CNNPolicy``) in ``spec`` (the 50-robot ``circle``), on
    the policy's device.  The pose noise is drawn from a generator seeded
    with ``seed``, or given as ``noise`` (A, N, 2).  ``env_kwargs`` forwards
    to :class:`Env` (``{"disc_cull_k": 12}`` for the culled rect path)."""
    spec = spec or circle_world()
    device = next(policy.parameters()).device
    env = Env(spec, device=device, seed=seed, **(env_kwargs or {}))
    if noise is None and pose_noise:
        gen = torch.Generator(device=device).manual_seed(seed)
        noise = pose_noise_draw(n_arenas, spec.n_robots, pose_noise, gen)
    results = run_episodes(policy, env, n_arenas, max_steps, noise)
    done_step, first_result, start_dist = (x.cpu().numpy() for x in results)
    return circle_metrics(spec, done_step, first_result, start_dist,
                          pose_noise, max_steps)
