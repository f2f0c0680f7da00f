"""The port's stage-1 env (engine/env.py, plain path on the CPU) against the
JAX package's Env, step for step with the same state, actions and reset
draws, plus the behaviour cases of tests/test_env.py and the samplers'
distributions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.engine import sampling as jsampling
from rl_collision_avoidance_tpu.engine.env import Env as JEnv
from rl_collision_avoidance_tpu.worlds import mini as jmini
from rl_collision_avoidance_tpu.worlds import stage1 as jstage1

from rl_collision_avoidance_torch.engine import sampling
from rl_collision_avoidance_torch.engine.env import (RESULT_CRASH, RESULT_GOAL,
                                                     RESULT_TIMEOUT, Env,
                                                     EnvState, local_goal)
from rl_collision_avoidance_torch.worlds import mini, stage1
from torch_parity import ATOL, assert_frame_matches_jax

T = torch.from_numpy
FIELDS = ("pose", "speed", "goal", "dist", "step", "scan_hist", "ep_return")


def _to_torch(jstate) -> EnvState:
    return EnvState(**{f: torch.tensor(np.asarray(getattr(jstate, f)))
                       for f in FIELDS})


def _jax_reset_draw(jenv, keys, cur_pose):
    """The (pose, goal) sample JAX's Env draws from ``keys`` (A,)."""
    k = jax.vmap(lambda key: jax.random.split(key, 2))(keys)[:, 1]
    pose, goal = jenv._sample_pose_goal(k, cur_pose)
    return torch.tensor(np.asarray(pose)), torch.tensor(np.asarray(goal))


def _check_scans(env, mine, ref, pose, prev=None, reset=None):
    """The newest frame is held to the lidar parity rule of torch_parity;
    the older frames are the previous history shifted by one (``prev``), or
    the newest frame again for robots that were reset (all at ``reset``)."""
    assert_frame_matches_jax(env, mine[..., -1, :], ref[..., -1, :], pose)
    older = np.repeat(mine[..., -1:, :], mine.shape[-2] - 1, axis=-2)
    if prev is not None:
        older = np.where(reset[..., None, None], older, prev[..., 1:, :])
    np.testing.assert_array_equal(mine[..., :-1, :], older)


def _force_events(spec, jstate, arena=0):
    """Robot 0 0.45 m short of its goal facing it, robot 1 0.3 m from the
    east wall facing it, robot 2 at the timeout."""
    pose = np.array(jstate.pose)
    goal = np.asarray(jstate.goal)
    pose[arena, 0] = [goal[arena, 0, 0] - 0.55, goal[arena, 0, 1], 0.0]
    pose[arena, 1] = [9.7 if spec.name == "mini" else 9.3, 0.0, 0.0]
    step = np.array(jstate.step)
    step[arena, 2] = spec.timeout
    dist = np.linalg.norm(goal - pose[..., :2], axis=-1)
    return jstate.replace(pose=jnp.asarray(pose), step=jnp.asarray(step),
                          dist=jnp.asarray(dist, jnp.float32))


@pytest.mark.parametrize("world,lidar_mode", [("mini", "pallas"),
                                              ("stage1", "xla")])
def test_reset_and_steps_match_jax(world, lidar_mode):
    spec, jspec = {"mini": (mini, jmini), "stage1": (stage1, jstage1)}[world]
    spec, jspec = spec(), jspec()
    arenas, steps = 2, 6
    jenv = JEnv(jspec, lidar_mode=lidar_mode)
    env = Env(spec, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(7), arenas)
    jstate, jobs = jax.jit(jenv.reset)(keys)
    pose0, goal0 = _jax_reset_draw(jenv, keys, jnp.zeros((arenas,
                                                          spec.n_robots, 3)))
    state, obs = env.reset(arenas, pose0, goal0)
    for f in FIELDS[:-2]:
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)), atol=ATOL,
                                   err_msg=f)
    _check_scans(env, obs.scans.numpy(), np.asarray(jobs.scans),
                 pose0.numpy())
    np.testing.assert_allclose(obs.goal.numpy(), np.asarray(jobs.goal),
                               atol=ATOL)

    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(3)
    events = np.zeros(4, int)
    for i in range(steps):
        if i == 0:
            jstate = _force_events(spec, jstate)
        act = rng.uniform([-0.2, -1.3], [1.2, 1.3],
                          (arenas, spec.n_robots, 2)).astype(np.float32)
        if i == 0:
            act[0, :2] = [1.0, 0.0]
        rp, rg = _jax_reset_draw(jenv, jstate.key, jstate.pose)
        state = _to_torch(jstate)
        prev = state.scan_hist.numpy()
        jstate, jobs, jr, jd, jinfo = jstep(jstate, jnp.asarray(act))
        state, obs, r, d, info = env.step(state, T(act), rp, rg)
        for f in ("pose", "speed", "goal", "dist", "ep_return"):
            np.testing.assert_allclose(getattr(state, f).numpy(),
                                       np.asarray(getattr(jstate, f)),
                                       atol=ATOL, err_msg=f)
        np.testing.assert_array_equal(state.step.numpy(),
                                      np.asarray(jstate.step))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=ATOL)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(info.result.numpy(),
                                      np.asarray(jinfo.result))
        np.testing.assert_allclose(info.ep_return.numpy(),
                                   np.asarray(jinfo.ep_return), atol=ATOL)
        np.testing.assert_allclose(obs.goal.numpy(), np.asarray(jobs.goal),
                                   atol=ATOL)
        _check_scans(env, obs.scans.numpy(), np.asarray(jobs.scans),
                     state.pose.numpy(), prev, d.numpy())
        events += np.bincount(info.result.numpy().ravel(), minlength=4)
    assert events[1:].all(), events  # goal, crash and timeout all happened


# ---------------------------------------------------------------------------
# behaviour, on the port alone (mirrors tests/test_env.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def env():
    return Env(mini(), device="cpu", seed=0)


def _with(env, state, pose):
    pose = torch.as_tensor(pose, dtype=torch.float32)
    return dataclasses.replace(
        state, pose=pose,
        dist=torch.linalg.vector_norm(state.goal - pose[..., :2], dim=-1))


def test_reset_invariants(env):
    state, obs = env.reset(1)
    pos = state.pose[0, :, :2]
    assert (torch.linalg.vector_norm(pos, dim=-1) <= 9.0 + 1e-5).all()
    d = torch.linalg.vector_norm(state.goal[0] - pos, dim=-1)
    assert ((d >= 8.0 - 1e-5) & (d <= 10.0 + 1e-5)).float().mean() >= 0.75
    torch.testing.assert_close(state.dist[0], d)
    s = obs.scans[0]
    assert torch.equal(s[:, 0], s[:, 1]) and torch.equal(s[:, 1], s[:, 2])
    assert int(state.step.sum()) == 0


def test_progress_reward(env):
    state, _ = env.reset(1)
    to_goal = state.goal - state.pose[..., :2]
    pose = state.pose.clone()
    pose[..., 2] = torch.atan2(to_goal[..., 1], to_goal[..., 0])
    state = _with(env, state, pose)
    d0 = state.dist.clone()
    act = torch.tensor([1.0, 0.0]).expand(1, env.n_robots, 2)
    state, _, r, _, info = env.step(state, act)
    moved = ~info.crashed
    torch.testing.assert_close(r[moved], torch.full_like(r[moved], 0.25),
                               atol=1e-3, rtol=0)
    torch.testing.assert_close((d0 - state.dist)[moved],
                               torch.full_like(r[moved], 0.1), atol=1e-4,
                               rtol=0)


def test_goal_reward_and_reset(env):
    state, _ = env.reset(1)
    g = state.goal[0, 0]
    pose = state.pose.clone()
    pose[0, 0] = torch.stack([g[0] - 0.55, g[1], torch.tensor(0.0)])
    state = _with(env, state, pose)
    act = torch.zeros(1, env.n_robots, 2)
    act[0, 0, 0] = 1.0
    state, _, r, done, info = env.step(state, act)
    assert float(r[0, 0]) == pytest.approx(15.0)
    assert bool(done[0, 0]) and int(info.result[0, 0]) == RESULT_GOAL
    assert int(state.step[0, 0]) == 0 and float(state.dist[0, 0]) > 0.5
    assert torch.equal(state.speed[0, 0], torch.zeros(2))


def test_crash_reward(env):
    state, _ = env.reset(1)
    pose = state.pose.clone()
    pose[0, 0] = torch.tensor([9.7, 0.0, 0.0])
    state = _with(env, state, pose)
    act = torch.zeros(1, env.n_robots, 2)
    act[0, 0, 0] = 1.0
    _, _, r, done, info = env.step(state, act)
    assert bool(info.crashed[0, 0]) and bool(done[0, 0])
    assert int(info.result[0, 0]) == RESULT_CRASH
    assert float(r[0, 0]) == pytest.approx(-15.0, abs=1e-5)


def test_timeout(env):
    state, _ = env.reset(1)
    state = dataclasses.replace(state, step=torch.full_like(state.step, 150))
    state, _, _, done, info = env.step(state, torch.zeros(1, env.n_robots, 2))
    assert bool(done.all()) and bool((info.result == RESULT_TIMEOUT).all())
    assert int(state.step.abs().sum()) == 0


def test_spin_penalty_reads_realized_w():
    """w is clipped to 1.0 < omega_thresh = 1.05 at stage 1, so no penalty;
    with a lower threshold a free spinning robot pays -0.1 |w| and a
    stalled one, whose pose did not turn, pays nothing."""
    env = Env(mini(), device="cpu", seed=1)
    state, _ = env.reset(1)
    act = torch.tensor([0.0, 1.1]).expand(1, env.n_robots, 2)
    _, _, r, _, _ = env.step(state, act)
    torch.testing.assert_close(r, torch.zeros_like(r), atol=1e-5, rtol=0)

    env = Env(dataclasses.replace(mini(), omega_thresh=0.7), device="cpu")
    state, _ = env.reset(1)
    pose = state.pose.clone()
    pose[0, 0] = torch.tensor([9.9, 0.0, 0.0])       # touching the east wall
    state = _with(env, state, pose)
    act = torch.tensor([0.0, 0.9]).repeat(1, env.n_robots, 1)
    act[0, 0] = torch.tensor([1.0, 0.9])
    _, _, r, _, info = env.step(state, act)
    _, _, r0, _, info0 = env.step(state, act * torch.tensor([1.0, 0.0]))
    assert bool(info.crashed[0, 0])
    assert float(r[0, 0]) == pytest.approx(-15.0, abs=1e-5)
    free = ~(info.crashed | info0.crashed)
    torch.testing.assert_close((r - r0)[free],
                               torch.full_like(r[free], -0.09), atol=1e-5,
                               rtol=0)


def test_local_goal_frame(env):
    state, obs = env.reset(1)
    pose, goal = state.pose[0].numpy(), state.goal[0].numpy()
    for i in range(env.n_robots):
        dx, dy = goal[i] - pose[i, :2]
        th = pose[i, 2]
        np.testing.assert_allclose(
            obs.goal[0, i].numpy(),
            [dx * np.cos(th) + dy * np.sin(th),
             -dx * np.sin(th) + dy * np.cos(th)], atol=1e-5)
    np.testing.assert_allclose(
        local_goal(state.pose, state.goal).norm(dim=-1).numpy(),
        np.linalg.norm(goal - pose[:, :2], axis=-1)[None], rtol=1e-5)


def test_determinism():
    act = torch.tensor([0.7, 0.2]).expand(2, 4, 2)
    outs = []
    for _ in range(2):
        env = Env(mini(), device="cpu", seed=42)
        state, _ = env.reset(2)
        for _ in range(10):
            state, _, r, _, _ = env.step(state, act)
        outs.append((state.pose, r))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _ks(a, b):
    """Two-sample Kolmogorov-Smirnov statistic."""
    grid = np.sort(np.concatenate([a, b]))
    cdf = lambda x: np.searchsorted(np.sort(x), grid, side="right") / len(x)
    return np.abs(cdf(a) - cdf(b)).max()


def test_sampler_distributions_match_jax():
    """stage1_poses / stage1_goals: uniform in the 9 m disc, goals 8-10 m
    away and inside the disc, distributed as JAX's samplers draw them.  At
    20,000 draws a side, a KS statistic above 0.025 has probability < 1e-5
    for two samples of one distribution."""
    n, radius = 20000, 9.0
    g = torch.Generator().manual_seed(0)
    pose = sampling.stage1_poses((n,), radius, g, "cpu")
    goal = sampling.stage1_goals(pose[:, :2], radius, 8.0, 10.0, g)
    kp, kg = jax.random.split(jax.random.PRNGKey(0))
    jpose = np.asarray(jsampling.stage1_poses(kp, n, radius))
    jgoal = np.asarray(jsampling.stage1_goals(kg, jnp.asarray(jpose[:, :2]),
                                              radius, 8.0, 10.0))
    r = torch.linalg.vector_norm(pose[:, :2], dim=-1).numpy()
    d = torch.linalg.vector_norm(goal - pose[:, :2], dim=-1).numpy()
    assert r.max() <= radius + 1e-5
    assert np.linalg.norm(goal.numpy(), axis=-1).max() <= radius + 1e-4
    assert ((d >= 8.0 - 1e-4) & (d <= 10.0 + 1e-4)).mean() >= 0.999
    uniform = np.linspace(0.0, 1.0, n)
    assert _ks(r ** 2 / radius ** 2, uniform) < 0.025
    assert _ks(pose[:, 2].numpy() / (2 * np.pi), uniform) < 0.025
    for mine, ref in ((r, np.linalg.norm(jpose[:, :2], axis=-1)),
                      (d, np.linalg.norm(jgoal - jpose[:, :2], axis=-1)),
                      (np.linalg.norm(goal.numpy(), axis=-1),
                       np.linalg.norm(jgoal, axis=-1))):
        assert _ks(mine, ref) < 0.025


def test_env_draws_come_from_its_generator():
    a, b = (Env(mini(), device="cpu", seed=5) for _ in range(2))
    sa, _ = a.reset(3)
    sb, _ = b.reset(3)
    assert torch.equal(sa.pose, sb.pose) and torch.equal(sa.goal, sb.goal)
    sc, _ = Env(mini(), device="cpu", seed=6).reset(3)
    assert not torch.equal(sa.pose, sc.pose)
