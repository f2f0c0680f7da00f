"""The port's rect footprint through the env, the circle eval, one
training update and the CLI, against the JAX package on the CPU with the
same seeded inputs and draws; the lidar frames by the rule of
tests/test_torch_rect.py (torch_parity's, the boxes' half-dims perturbed)."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from rl_collision_avoidance_tpu.engine.env import Env as JEnv
from rl_collision_avoidance_tpu.eval import circle as jcircle_eval
from rl_collision_avoidance_tpu.worlds import circle as jcircle
from rl_collision_avoidance_tpu.worlds import circle_tables as jcircle_tables
from rl_collision_avoidance_tpu.worlds import get_world as jget_world

from rl_collision_avoidance_torch import cli
from rl_collision_avoidance_torch.engine.env import (RESULT_CRASH, RESULT_GOAL,
                                                     RESULT_TIMEOUT, Env)
from rl_collision_avoidance_torch.eval import circle as circle_eval
from rl_collision_avoidance_torch.models import load_policy
from rl_collision_avoidance_torch.train import TrainConfig
from rl_collision_avoidance_torch.worlds import (circle, circle_tables,
                                                 stage1_rect)
from test_torch_rect import assert_any_frame_matches_jax
from torch_parity import (assert_one_update_matches_jax,
                          assert_step_matches_jax, jax_params,
                          jax_reset_draw, jax_step_draw, to_torch_state)

ROOT = Path(__file__).resolve().parents[1]
T = torch.from_numpy


# ---------------------------------------------------------------------------
# the env
# ---------------------------------------------------------------------------


def _ring(n, radius):
    """(port, JAX) circle specs with the box footprint, n robots on a ring
    of ``radius``."""
    poses, goals = circle_tables(n, radius)
    jposes, jgoals = jcircle_tables(n, radius)
    return (dataclasses.replace(circle(n), init_pose_table=poses,
                                goal_table=goals, footprint="rect"),
            dataclasses.replace(jcircle(n), init_pose_table=jposes,
                                goal_table=jgoals, footprint="rect"))


def _short_of_goal(pose, goal, by=0.55):
    d = goal - pose[:2]
    th = np.arctan2(d[1], d[0])
    return [*(goal - by * np.array([np.cos(th), np.sin(th)])), th]


@pytest.mark.parametrize("world,disc_k", [("stage1_rect", None),
                                          ("circle", None), ("circle", 12)])
def test_rect_env_reset_and_steps_match_jax(world, disc_k, monkeypatch):
    """Two arenas, reset and three steps, against JAX Env(lidar_mode="xla")
    with the same state, actions and reset draws.  stage1_rect: robot 0
    reaches its goal, robot 1 drives into the east wall, robot 2 times
    out.  circle (24 robots on a 4 m ring, every other robot within sensor
    range; rect, exact or culled to the 12 nearest): robot 0 reaches its
    goal, robots 1 and 2 collide head on."""
    # torch_parity's scan check with the env's own silhouettes
    monkeypatch.setattr(torch_parity, "assert_frame_matches_jax",
                        assert_any_frame_matches_jax)
    arenas, steps = 2, 3
    if world == "stage1_rect":
        spec, jspec = stage1_rect(), jget_world("stage1_rect")
    else:
        spec, jspec = _ring(24, 4.0)
    n = spec.n_robots
    kw = {} if disc_k is None else {"disc_cull_k": disc_k}
    jenv = JEnv(jspec, lidar_mode="xla", **kw)
    env = Env(spec, device="cpu", **kw)
    assert env.walls_only and env.rect_silhouette
    keys = jax.random.split(jax.random.PRNGKey(13), arenas)
    jstate, jobs = jax.jit(jenv.reset)(keys)
    pose0, goal0 = jax_reset_draw(jenv, keys, jnp.zeros((arenas, n, 3)))
    state, obs = env.reset(arenas, pose0, goal0)
    np.testing.assert_allclose(state.pose.numpy(), np.asarray(jstate.pose),
                               atol=1e-5)
    torch_parity.check_scans(env, obs.scans.numpy(), np.asarray(jobs.scans),
                             pose0.numpy())
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(17)
    events = np.zeros(4, int)
    for i in range(steps):
        act = rng.uniform([-0.2, -1.3], [1.2, 1.3],
                          (arenas, n, 2)).astype(np.float32)
        if i == 0:
            p, g = np.array(jstate.pose), np.asarray(jstate.goal)
            p[0, 0] = _short_of_goal(p[0, 0], g[0, 0])
            act[0, 0] = [1.0, 0.0]
            if world == "circle":
                act[0, n // 2] = [0.0, 0.0]   # the robot on robot 0's goal
            if world == "stage1_rect":
                p[0, 1] = [9.3, 0.0, 0.0]         # the box's front at 9.52
                act[0, 1] = [1.0, 0.0]
                st = np.array(jstate.step)
                st[0, 2] = spec.timeout
                jstate = jstate.replace(step=jnp.asarray(st))
            else:
                p[0, 2] = [*(p[0, 1, :2] + 0.5 * np.array(
                    [np.cos(p[0, 1, 2]), np.sin(p[0, 1, 2])])), p[0, 1, 2]]
                act[0, 1], act[0, 2] = [1.0, 0.0], [0.0, 0.0]
            dist = np.linalg.norm(g - p[..., :2], axis=-1)
            if spec.dist_prev_zero_on_reset:
                dist = np.asarray(jstate.dist)
            jstate = jstate.replace(pose=jnp.asarray(p),
                                    dist=jnp.asarray(dist, jnp.float32))
        rp, rg = jax_step_draw(jenv, jstate, jnp.asarray(act))
        state = to_torch_state(jstate)
        prev = state.scan_hist.numpy()
        ref = jstep(jstate, jnp.asarray(act))
        port = env.step(state, T(act), rp, rg)
        assert_step_matches_jax(env, prev, port, ref)
        jstate = ref[0]
        info = port[4]
        events += np.bincount(info.result.numpy().ravel(), minlength=4)
        if i == 0:
            assert int(info.result[0, 0]) == RESULT_GOAL
            if world == "circle":
                assert (info.result[0, 1:3] == RESULT_CRASH).all()
            else:
                assert int(info.result[0, 1]) == RESULT_CRASH
                assert int(info.result[0, 2]) == RESULT_TIMEOUT
    assert events[RESULT_GOAL] and events[RESULT_CRASH], events


# ---------------------------------------------------------------------------
# the circle eval, one update, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("disc_k", [None, 4])
def test_rect_circle_eval_matches_jax(disc_k):
    """The rect circle eval on an 8-robot ring of 3 m, 200 steps with the
    fine-tuned weights, exact and culled to the 4 nearest (of 7, all within
    range), with the pose noise of JAX's draw injected, against the JAX
    package's run_circle_eval (tests/test_torch_circle.py::
    test_circle_eval_matches_jax).  Exact: two arenas, the second at 0.1 m
    of noise; every robot's first result and step and the metrics equal.
    Culled: three arenas; every first result equal, and the steps of the
    perturbed arenas.  On the unperturbed ring, mirror-image robots lie at
    equal distances, and where such a tie falls on the k-th place each
    package keeps the robot its own rounding of |c - o|^2 puts first; the
    two choices are equally right and move a robot's finishing step by a
    few steps (121 against 115 read once)."""
    n, radius, noise_m, steps = 8, 3.0, 0.1, 200
    arenas = 2 if disc_k is None else 3
    spec, jspec = _ring(n, radius)
    kw = {} if disc_k is None else {"disc_cull_k": disc_k}
    model, jparams = jax_params(ROOT / "results" / "circle_ft_params.npz")
    # lidar_mode="xla": the JAX env's CPU default, the dense scan, ignores
    # disc_cull_k
    want = jcircle_eval.run_circle_eval(jparams, model, spec=jspec,
                                        max_steps=steps, seed=0,
                                        n_arenas=arenas, pose_noise=noise_m,
                                        env_kwargs={"lidar_mode": "xla", **kw})
    jenv = next(e for e in jcircle_eval._ENV_CACHE.values()
                if e.lidar_mode == "xla" and e.disc_cull_k == disc_k
                and e.n_robots == n and np.array_equal(
                    e.spec.init_pose_table, jspec.init_pose_table))
    keys = jax.random.split(jax.random.PRNGKey(0), arenas)
    jdone, jfirst, jstart = jax.device_get(jcircle_eval._run(
        jparams, model, jenv, steps, keys, noise_m))
    noise = np.array(jax.vmap(lambda k: jax.random.uniform(
        jax.random.fold_in(k, 1), (n, 2), minval=-noise_m,
        maxval=noise_m))(keys))

    policy = load_policy(ROOT / "results" / "circle_ft_params.npz",
                         device="cpu")
    done, first, start = circle_eval.run_episodes(
        policy, Env(spec, device="cpu", **kw), arenas, steps, T(noise))
    np.testing.assert_array_equal(first.numpy(), jfirst)
    assert (jfirst == RESULT_GOAL).any()
    np.testing.assert_allclose(start.numpy(), jstart, atol=1e-5)
    if disc_k is not None:
        np.testing.assert_array_equal(done.numpy()[1:], jdone[1:])
    else:
        np.testing.assert_array_equal(done.numpy(), jdone)
        got = circle_eval.circle_metrics(spec, done.numpy(), first.numpy(),
                                         start.numpy(), noise_m, steps)
        for k, v in want.items():
            if v is None:
                assert got[k] is None, k
            else:
                assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-5), k
    # run_circle_eval forwards env_kwargs to Env
    assert circle_eval.run_circle_eval(policy, spec, max_steps=2,
                                       env_kwargs=kw)["n_robots"] == n


def test_one_stage1_rect_update_matches_jax_chain():
    """The stage-1 preset on stage1_rect, one arena of 24, horizon 8,
    minibatches of 48, from random weights as tests/test_torch_train.py::
    test_one_update_matches_jax_chain starts, at its tolerances (every
    element of every leaf, no outliers): robots 0-3 start at the timeout's
    edge, so episodes end inside the rollout.  (From the committed stage-1
    weights the policy loss, whose terms cancel to ~5e-4 of their size over
    an epoch, differs from JAX's by 2.6e-7, 5e-4 of its value: beyond the
    metrics' 1e-4, which is made for sums that do not cancel.)"""
    cfg = TrainConfig.stage1(n_arenas=1, horizon=8, world="stage1_rect")
    cfg.ppo = cfg.ppo._replace(batch_size=48)
    steps = np.zeros((1, 24), np.int32)
    steps[0, :4] = [146, 147, 148, 149]
    model = jax_params(ROOT / "results" / "stage1_params.npz")[0]
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, 512)),
                        jnp.zeros((1, 2)), jnp.zeros((1, 2)))
    metrics, jm = assert_one_update_matches_jax(
        cfg, JEnv(jget_world("stage1_rect"), lidar_mode="xla"), model,
        params, steps)
    assert jm["episodes"] >= 4


def test_cli_rect(tmp_path, capsys):
    """circle-test --footprint rect and train-stage1 --world stage1_rect on
    the CPU, at a tiny size."""
    cli.main(["circle-test", "--params",
              str(ROOT / "results" / "circle_ft_params.npz"), "--footprint",
              "rect", "--max-steps", "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_robots"] == 50 and out["max_steps"] == 2
    cli.main(["train-stage1", "--world", "stage1_rect", "--arenas", "1",
              "--updates", "1", "--batch-size", "1536", "--device", "cpu",
              "--log-dir", str(tmp_path), "--warm-start",
              str(ROOT / "results" / "stage1_params.npz")])
    assert (tmp_path / "metrics.csv").is_file()
    assert (tmp_path / "stage1_params.npz").is_file()
