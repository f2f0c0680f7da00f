"""The port's circle worlds (``circle``: ``FIXED_TABLES``, never reset;
``circle_train``: one jittered reset group) and its circle-50 eval
(``eval/circle.py``) against the JAX package, plus the circle cases of
tests/test_env.py and tests/test_eval.py on the port alone.

Parity runs the env's plain path on the CPU with the same state, actions
and reset draws on both sides (``torch_parity``).  The rings are shrunk
(``circle_tables(n, radius)`` swapped into both packages' specs) so that
robots see each other and finish within a few hundred steps."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.engine.env import Env as JEnv
from rl_collision_avoidance_tpu.eval import circle as jcircle_eval
from rl_collision_avoidance_tpu.worlds import circle as jcircle
from rl_collision_avoidance_tpu.worlds import circle_tables as jcircle_tables
from rl_collision_avoidance_tpu.worlds import circle_train as jcircle_train

from rl_collision_avoidance_torch import cli
from rl_collision_avoidance_torch.engine.env import (RESULT_CRASH, RESULT_GOAL,
                                                     Env)
from rl_collision_avoidance_torch.eval import circle as circle_eval
from rl_collision_avoidance_torch.models import CNNPolicy, load_policy
from rl_collision_avoidance_torch.train import TrainConfig
from rl_collision_avoidance_torch.utils.params import (load_jax_npz,
                                                       save_params_npz,
                                                       torch_to_jax_params)
from rl_collision_avoidance_torch.worlds import (circle, circle_tables,
                                                 circle_train)
from torch_parity import (assert_one_update_matches_jax,
                          assert_step_matches_jax, check_scans, jax_params,
                          jax_reset_draw, jax_step_draw, to_torch_state)

ROOT = Path(__file__).resolve().parents[1]
T = torch.from_numpy


@pytest.mark.parametrize("n,radius", [(50, 25.0), (12, 25.0), (8, 3.0)])
def test_circle_tables_are_the_jax_ones(n, radius):
    for a, b in zip(circle_tables(n, radius), jcircle_tables(n, radius)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _small_ring(make, jmake, n, radius):
    """(port spec, JAX spec) of world ``make``/``jmake`` with ``n`` robots
    on a ring of ``radius``."""
    poses, goals = circle_tables(n, radius)
    jposes, jgoals = jcircle_tables(n, radius)
    return (dataclasses.replace(make(n), init_pose_table=poses,
                                goal_table=goals),
            dataclasses.replace(jmake(n), init_pose_table=jposes,
                                goal_table=jgoals))


def _put(jstate, robots, pose):
    """jstate with the robots (arena 0) at ``pose`` (k, 3)."""
    p = np.array(jstate.pose)
    p[0, robots] = pose
    return jstate.replace(pose=jnp.asarray(p))


def _short_of_goal(jstate, robots, by=0.55):
    """Poses ``by`` m short of each robot's goal (arena 0), facing it."""
    pose = np.asarray(jstate.pose)[0, robots]
    goal = np.asarray(jstate.goal)[0, robots]
    d = goal - pose[:, :2]
    th = np.arctan2(d[:, 1], d[:, 0])
    xy = goal - by * np.stack([np.cos(th), np.sin(th)], -1)
    return np.concatenate([xy, th[:, None]], -1)


@pytest.mark.parametrize("world", ["circle", "circle_train"])
def test_circle_reset_and_steps_match_jax(world):
    """Two arenas of 12 robots on a 4 m ring, reset and six steps.  circle:
    robot 0 reaches its goal at the first step and spins in place dead
    afterwards, robots 1 and 2 crash into each other.  circle_train:
    robot 0 reaches its goal first and waits dead; at the fourth step every
    other robot of arena 0 reaches its goal and the ring resets, jittered."""
    arenas, steps, n = 2, 6, 12
    make, jmake = {"circle": (circle, jcircle),
                   "circle_train": (circle_train, jcircle_train)}[world]
    spec, jspec = _small_ring(make, jmake, n, 4.0)
    jenv = JEnv(jspec, lidar_mode="pallas")
    env = Env(spec, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(21), arenas)
    jstate, jobs = jax.jit(jenv.reset)(keys)
    pose0, goal0 = jax_reset_draw(jenv, keys, jnp.zeros((arenas, n, 3)))
    state, obs = env.reset(arenas, pose0, goal0)
    for f in ("pose", "speed", "goal", "dist", "step", "dead"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)),
                                   atol=1e-5, err_msg=f)
    check_scans(env, obs.scans.numpy(), np.asarray(jobs.scans),
                pose0.numpy())

    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(9)
    for i in range(steps):
        act = rng.uniform([-0.2, -1.3], [1.2, 1.3],
                          (arenas, n, 2)).astype(np.float32)
        if i == 0:
            jstate = _put(jstate, [0], _short_of_goal(jstate, [0]))
            act[0, 0] = [1.0, 0.4]
            if world == "circle":
                p1 = np.asarray(jstate.pose)[0, 1]
                ahead = p1[:2] + 0.5 * np.array([np.cos(p1[2]),
                                                 np.sin(p1[2])])
                jstate = _put(jstate, [2], [[*ahead, p1[2]]])
                act[0, 1], act[0, 2] = [1.0, 0.0], [0.0, 0.0]
        if i == 3 and world == "circle_train":
            others = list(range(1, n))
            jstate = _put(jstate, others, _short_of_goal(jstate, others))
            act[0, 1:] = [1.0, 0.0]
        rp, rg = jax_step_draw(jenv, jstate, jnp.asarray(act))
        state = to_torch_state(jstate)
        prev = state.scan_hist.numpy()
        ref = jstep(jstate, jnp.asarray(act))
        port = env.step(state, T(act), rp, rg)
        assert_step_matches_jax(env, prev, port, ref)
        jstate = ref[0]
        new, info = port[0], port[4]
        if i == 0:
            assert int(info.result[0, 0]) == RESULT_GOAL and new.dead[0, 0]
            if world == "circle":
                assert (info.result[0, 1:3] == RESULT_CRASH).all()
        if world == "circle" and i > 0:
            # a finished robot stops translating but keeps steering
            assert new.dead[0, 0] and not info.valid[0, 0]
            assert float(new.speed[0, 0, 0]) == 0.0
            assert float(new.speed[0, 0, 1]) != 0.0
        if world == "circle_train" and i == 3:
            assert not new.dead[0].any() and (new.step[0] == 0).all()
            dev = new.pose[0, :, :2].numpy() - spec.init_pose_table[:, :2]
            assert np.abs(dev).max() <= spec.pose_jitter + 1e-6


# ---------------------------------------------------------------------------
# behaviour, on the port alone (mirrors tests/test_env.py:214-326)
# ---------------------------------------------------------------------------


def test_circle_never_resets():
    env = Env(circle(), device="cpu")
    state, _ = env.reset(1)
    pose0 = state.pose.clone()
    np.testing.assert_allclose(pose0[0, 0, :2].numpy(), [25.0, 0.0],
                               atol=1e-5)
    state = dataclasses.replace(state, dead=torch.ones(1, 50,
                                                       dtype=torch.bool))
    state, _, _, done, info = env.step(state, torch.ones(1, 50, 2))
    assert state.dead.all() and done.all() and not info.valid.any()
    # finished robots stop translating but keep steering (circle_test.py:64-66)
    torch.testing.assert_close(state.pose[..., :2], pose0[..., :2])
    torch.testing.assert_close(state.pose[..., 2],
                               pose0[..., 2] + 1.0 * env.spec.dt)
    torch.testing.assert_close(state.speed,
                               torch.tensor([0.0, 1.0]).expand(1, 50, 2))


def test_circle_spin_penalty_uses_realized_w():
    """omega_thresh = 0.7 in the circle world (circle_world.py:195): a live
    spinning robot pays -0.1 |w|; differenced against a no-spin step, as
    the first progress reward is -2.5 dist (dist_prev_zero_on_reset)."""
    env = Env(circle(), device="cpu")
    state, _ = env.reset(1)
    act = torch.tensor([0.0, 0.9]).expand(1, 50, 2)
    _, _, r, _, info = env.step(state, act)
    _, _, r0, _, info0 = env.step(state, act * 0.0)
    free = ~(info.crashed | info0.crashed)
    assert free.all()
    torch.testing.assert_close((r - r0)[free],
                               torch.full_like(r[free], -0.09), atol=1e-3,
                               rtol=0)


def test_teleport():
    """control_pose: the teleported robot has exactly the commanded pose,
    the others keep theirs, and the goal distance is re-derived."""
    env = Env(circle(), device="cpu")
    state, _ = env.reset(1)
    target = state.pose.clone()
    target[0, 0] = torch.tensor([3.0, -2.0, 1.5])
    mask = torch.zeros(1, 50, dtype=torch.bool)
    mask[0, 0] = True
    new = env.teleport(state, target, mask)
    assert torch.equal(new.pose[0, 0], torch.tensor([3.0, -2.0, 1.5]))
    assert torch.equal(new.pose[0, 1:], state.pose[0, 1:])
    want = np.linalg.norm(state.goal[0, 0].numpy() - [3.0, -2.0])
    assert float(new.dist[0, 0]) == pytest.approx(want, rel=1e-5)


def test_circle_train_jittered_group_reset():
    """circle_train: reset poses within +-pose_jitter of the tables, drawn
    per arena; headings and goals exact; the one group resets the whole
    ring, with a fresh jitter, once every robot is done."""
    spec = circle_train()
    env = Env(spec, device="cpu", seed=3)
    state, _ = env.reset(2)
    pose = state.pose.numpy()
    table = spec.init_pose_table
    assert np.abs(pose[..., :2] - table[None, :, :2]).max() <= (
        spec.pose_jitter + 1e-6)
    assert not np.allclose(pose[0], pose[1])
    np.testing.assert_array_equal(pose[..., 2],
                                  np.broadcast_to(table[:, 2], (2, 50)))
    np.testing.assert_array_equal(state.goal.numpy(),
                                  np.broadcast_to(spec.goal_table,
                                                  (2, 50, 2)))
    on_goal = torch.cat([state.goal, state.pose[..., 2:]], dim=-1)
    state = env.teleport(state, on_goal)
    state2, _, _, done, _ = env.step(state, torch.zeros(2, 50, 2))
    assert done.all() and not state2.dead.any()
    pose2 = state2.pose.numpy()
    assert np.abs(pose2[..., :2] - table[None, :, :2]).max() <= (
        spec.pose_jitter + 1e-6)
    assert not np.allclose(pose2, pose)


# ---------------------------------------------------------------------------
# the circle eval
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params", ["circle_ft_params.npz",
                                    "stage1_params.npz"])
def test_circle_eval_matches_jax(params):
    """The circle eval on an 8-robot ring of 3 m, two arenas with 0.1 m of
    pose noise (the JAX draw, injected), 200 steps (with the fine-tuned
    weights every robot reaches its goal by step 123; the stage-1 weights
    leave most unfinished): the same first result and step of every robot,
    and the same metrics dict, as the JAX package's run_circle_eval and
    its step loop."""
    n, radius, arenas, noise_m, steps = 8, 3.0, 2, 0.1, 200
    spec, jspec = _small_ring(circle, jcircle, n, radius)
    model, jparams = jax_params(ROOT / "results" / params)
    want = jcircle_eval.run_circle_eval(jparams, model, spec=jspec,
                                        max_steps=steps, seed=0,
                                        n_arenas=arenas, pose_noise=noise_m)
    # the env run_circle_eval cached for this ring, so its step loop is
    # compiled once
    jenv = next(e for e in jcircle_eval._ENV_CACHE.values()
                if e.n_robots == n and np.array_equal(
                    e.spec.init_pose_table, jspec.init_pose_table))
    keys = jax.random.split(jax.random.PRNGKey(0), arenas)
    jdone, jfirst, jstart = jax.device_get(jcircle_eval._run(
        jparams, model, jenv, steps, keys, noise_m))
    # the pose noise of JAX's _run, drawn the same way
    noise = np.array(jax.vmap(lambda k: jax.random.uniform(
        jax.random.fold_in(k, 1), (n, 2), minval=-noise_m,
        maxval=noise_m))(keys))

    policy = load_policy(ROOT / "results" / params, device="cpu")
    done, first, start = circle_eval.run_episodes(
        policy, Env(spec, device="cpu"), arenas, steps, T(noise))
    np.testing.assert_array_equal(first.numpy(), jfirst)
    np.testing.assert_array_equal(done.numpy(), jdone)
    np.testing.assert_allclose(start.numpy(), jstart, atol=1e-5)
    assert (jfirst != 0).any()
    got = circle_eval.circle_metrics(spec, done.numpy(), first.numpy(),
                                     start.numpy(), noise_m, steps)
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-5), k


def test_circle_eval_arena0_unperturbed_and_aggregates():
    """Arena 0 is the exact scenario whatever the noise; a random policy
    finishes nobody in 4 steps; the batched dict gains the mean and std."""
    torch.manual_seed(1)
    policy = CNNPolicy()
    single = circle_eval.run_circle_eval(policy, max_steps=4)
    batched = circle_eval.run_circle_eval(policy, max_steps=4, n_arenas=2,
                                          pose_noise=0.2)
    assert single["n_robots"] == 50 and single["success_rate"] == 0.0
    assert single["unfinished"] + single["collisions"] == 50
    assert single["mean_extra_time_s"] is None     # JSON null, not NaN
    for k in ("success_rate", "collisions", "unfinished"):
        assert batched[k] == single[k], k
    assert batched["n_arenas"] == 2
    assert 0.0 <= batched["success_rate_mean"] <= 1.0
    assert "success_rate_std" in batched and "mean_extra_time_std" in batched
    json.dumps(batched)


def test_circle_eval_noise_draw():
    g = torch.Generator().manual_seed(0)
    noise = circle_eval.pose_noise_draw(3, 50, 0.3, g)
    assert noise.shape == (3, 50, 2)
    assert noise.abs().max() <= 0.3 and noise.abs().max() > 0.29
    assert abs(float(noise.mean())) < 0.02


def test_circle_eval_runs_the_rect_and_culled_paths():
    """The box footprint and env_kwargs (disc_cull_k, forwarded to Env) run
    through run_circle_eval; an Env keyword that the JAX Env lacks too
    raises TypeError."""
    torch.manual_seed(2)
    policy = CNNPolicy()
    rect = dataclasses.replace(circle(), footprint="rect")
    for spec, kw in ((None, {"disc_cull_k": 12}), (rect, None),
                     (rect, {"disc_cull_k": 12})):
        out = circle_eval.run_circle_eval(policy, spec=spec, max_steps=2,
                                          env_kwargs=kw)
        assert out["n_robots"] == 50 and out["max_steps"] == 2
        assert out["unfinished"] + out["collisions"] == 50
    with pytest.raises(TypeError, match="no_such_option"):
        circle_eval.run_circle_eval(policy, max_steps=1,
                                    env_kwargs={"no_such_option": 1})


def test_cli_circle_test(tmp_path, capsys):
    """circle-test --device cpu prints the metrics dict as one JSON line."""
    cli.main(["circle-test", "--params",
              str(ROOT / "results" / "circle_ft_params.npz"), "--max-steps",
              "3", "--arenas", "2", "--pose-noise", "0.1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_robots"] == 50 and out["n_arenas"] == 2
    assert out["max_steps"] == 3 and out["unfinished"] == 50


def test_one_circle_ft_update_matches_jax_chain():
    """The circle_ft preset (circle_train, 4 epochs, logstd floor -2) from
    the fine-tuned weights, one arena of 50, horizon 8, minibatches of 80:
    every robot's timeout falls inside the rollout, the first ones wait
    dead, and the ring resets, jittered, when the last one ends.  Every
    leaf holds both rules with all its elements (at most 8.5e-5 in relative
    2-norm, 0.021 lr in one element).  actor1's weight and bias get no
    gradient (the fine-tuned sigmoid head is saturated in float32), so
    their JAX change is exactly zero and the port must leave them
    unchanged."""
    cfg = TrainConfig.circle_ft(n_arenas=1, horizon=8)
    cfg.ppo = cfg.ppo._replace(batch_size=80)
    steps = (693 + np.arange(50) % 8).astype(np.int32)[None]
    model, params = jax_params(ROOT / "results" / "circle_ft_params.npz")
    metrics, jm = assert_one_update_matches_jax(
        cfg, JEnv(jcircle_train(), lidar_mode="xla"), model, params, steps)
    assert jm["episodes"] == 50 and cfg.ppo.logstd_min == -2.0


def test_cli_train_circle(tmp_path):
    """train-circle --device cpu at a tiny size (the mini world, one update
    of 128 steps, 4 epochs of 4 minibatches) from params whose logstd lies
    below the preset's floor of -2: a circle_ft_params.npz whose logstd the
    floor has held."""
    torch.manual_seed(0)
    start = CNNPolicy(beams=64).state_dict()
    start["logstd"] = torch.full((2,), -3.0)
    save_params_npz(tmp_path / "start.npz", torch_to_jax_params(start))
    cli.main(["train-circle", "--world", "mini", "--arenas", "1",
              "--updates", "1", "--batch-size", "128", "--device", "cpu",
              "--log-dir", str(tmp_path), "--warm-start",
              str(tmp_path / "start.npz")])
    assert (tmp_path / "metrics.csv").is_file()
    # projected onto [-2, inf) after every step, then at most 16 steps of
    # lr 5e-5 above it
    logstd = load_jax_npz(tmp_path / "circle_ft_params.npz")["params"][
        "logstd"]
    assert logstd.min() >= -2.0 and logstd.max() < -2.0 + 16 * 5e-5
