"""The port's stage-2 world and env (``TABLES_THEN_CORRIDOR``: scenario
tables, corridor samplers, group resets, dead robots) against the JAX
package, plus the stage-2 cases of tests/test_env.py on the port alone.

The env runs its plain path on the CPU.  Parity steps feed both packages
the same state, actions and reset draws (``torch_parity``)."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.engine import sampling as jsampling
from rl_collision_avoidance_tpu.engine.env import Env as JEnv
from rl_collision_avoidance_tpu.worlds import get_world as jget_world
from rl_collision_avoidance_tpu.worlds import stage2_tables as jstage2_tables

from rl_collision_avoidance_torch import cli
from rl_collision_avoidance_torch.engine import sampling
from rl_collision_avoidance_torch.engine.env import (RESULT_CRASH, RESULT_GOAL,
                                                     RESULT_TIMEOUT, Env)
from rl_collision_avoidance_torch.train import TrainConfig
from rl_collision_avoidance_torch.worlds import (get_world, stage2,
                                                 stage2_tables)
from torch_parity import (ATOL, assert_one_update_matches_jax,
                          assert_step_matches_jax, check_scans, jax_params,
                          jax_reset_draw, jax_step_draw, to_torch_state)

ROOT = Path(__file__).resolve().parents[1]
T = torch.from_numpy
K = 32   # candidates per corridor draw, as both packages


@pytest.mark.parametrize("world,valid,padded", [("stage2", 166, 256),
                                                ("circle", 106, 128),
                                                ("circle_train", 106, 128)])
def test_geometry_table_is_the_jax_build(world, valid, padded):
    """The committed stage-2 and 60 m rink tables equal what the JAX package
    compiles from its images, padding included."""
    mine, ref = get_world(world), jget_world(world)
    for name in ("seg_p", "seg_e", "seg_valid"):
        a, b = getattr(mine, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(mine.seg_valid.sum()) == valid and mine.n_segments == padded


def test_stage2_tables_are_the_jax_ones():
    for a, b in zip(stage2_tables(), jstage2_tables()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", ["stage2", "circle", "circle_train"])
def test_world_constants_are_the_jax_ones(world):
    mine, ref = get_world(world), jget_world(world)
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if isinstance(a, np.ndarray) or a is None:
            assert (a is None) == (b is None), f.name
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "reset_mode":
            assert a.name == b.name
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# corridor samplers
# ---------------------------------------------------------------------------


def test_corridor_samplers_match_jax_on_the_same_uniforms():
    """corridor_poses_from / corridor_goals_from on the uniforms JAX's
    corridor_poses / corridor_goals draw inside equal their results."""
    n = 4000
    rng = np.random.default_rng(0)
    cur = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    cur[: n // 2] = rng.uniform([9, -19], [19, -1], (n // 2, 2))  # in the band
    kp, kg = jax.random.split(jax.random.PRNGKey(4))
    jpose = np.asarray(jsampling.corridor_poses(kp, jnp.asarray(cur)))
    jgoal = np.asarray(jsampling.corridor_goals(kg, jnp.asarray(jpose[:, :2])))
    up = np.array(jax.random.uniform(kp, (3, n, K)))
    ug = np.array(jax.random.uniform(kg, (2, n, K)))
    pose = sampling.corridor_poses_from(T(up), T(cur))
    goal = sampling.corridor_goals_from(T(ug), torch.tensor(jpose[:, :2]))
    np.testing.assert_allclose(pose.numpy(), jpose, rtol=0, atol=1e-6)
    np.testing.assert_allclose(goal.numpy(), jgoal, rtol=0, atol=1e-6)


def _ks(a, b):
    """Two-sample Kolmogorov-Smirnov statistic."""
    grid = np.sort(np.concatenate([a, b]))
    cdf = lambda x: np.searchsorted(np.sort(x), grid, side="right") / len(x)
    return np.abs(cdf(a) - cdf(b)).max()


def test_corridor_sampler_distributions_match_jax():
    """From the port's generator: inside the corridor band, >= 7 m from the
    current position and from the pose, and distributed as JAX's draws
    (KS statistic < 0.025 at 20,000 a side: probability < 1e-5 for two
    samples of one distribution)."""
    n = 20000
    cur = np.tile(np.asarray([[14.0, -3.0]], np.float32), (n, 1))
    g = torch.Generator().manual_seed(1)
    pose = sampling.corridor_poses(T(cur), g)
    goal = sampling.corridor_goals(pose[:, :2], g)
    kp, kg = jax.random.split(jax.random.PRNGKey(1))
    jpose = np.asarray(jsampling.corridor_poses(kp, jnp.asarray(cur)))
    jgoal = np.asarray(jsampling.corridor_goals(kg, jnp.asarray(jpose[:, :2])))
    xy = np.concatenate([pose[:, :2].numpy(), goal.numpy()])
    assert ((xy[:, 0] >= 9) & (xy[:, 0] <= 19)).all()
    assert (((xy[:, 1] >= -5) & (xy[:, 1] <= -1))
            | ((xy[:, 1] >= -19) & (xy[:, 1] <= -13))).all()
    d_pose = np.linalg.norm(pose[:, :2].numpy() - cur, axis=-1)
    d_goal = np.linalg.norm(goal.numpy() - pose[:, :2].numpy(), axis=-1)
    assert (d_pose >= 7.0).mean() > 0.9999 and (d_goal >= 7.0).mean() > 0.9999
    for mine, ref in ((pose[:, 0].numpy(), jpose[:, 0]),
                      (pose[:, 1].numpy(), jpose[:, 1]),
                      (pose[:, 2].numpy(), jpose[:, 2]),
                      (goal[:, 0].numpy(), jgoal[:, 0]),
                      (goal[:, 1].numpy(), jgoal[:, 1]), (d_goal,
                       np.linalg.norm(jgoal - jpose[:, :2], axis=-1))):
        assert _ks(mine, ref) < 0.025


# ---------------------------------------------------------------------------
# env steps against JAX
# ---------------------------------------------------------------------------


def _force_stage2_events(jstate):
    """Arena 0: robot 1 0.5 m ahead of robot 0, which drives into it (both
    crash and wait dead for group 0); robots 7-9 dead and robot 6 0.55 m
    short of its goal facing it (group 1 resets); robot 20 dead (frozen
    while group 4 runs); robots 35-43 dead and robot 34 at the timeout (the
    corridor group resets)."""
    pose = np.array(jstate.pose)
    goal = np.asarray(jstate.goal)
    th = pose[0, 0, 2]
    pose[0, 1, :2] = pose[0, 0, :2] + 0.5 * np.array([np.cos(th), np.sin(th)])
    pose[0, 6] = [goal[0, 6, 0] - 0.55, goal[0, 6, 1], 0.0]
    dead = np.zeros(pose.shape[:2], bool)
    dead[0, 7:10] = dead[0, 20] = True
    dead[0, 35:44] = True
    step = np.array(jstate.step)
    step[0, 34] = 200
    return jstate.replace(pose=jnp.asarray(pose), dead=jnp.asarray(dead),
                          step=jnp.asarray(step))


def test_stage2_reset_and_steps_match_jax():
    """Two arenas of stage 2, reset and six steps, with a crash, a goal, a
    timeout, two group resets (a table group and the corridor group) and
    dead robots frozen at the first step."""
    arenas, steps = 2, 6
    spec = stage2()
    jenv = JEnv(jget_world("stage2"), lidar_mode="xla")
    env = Env(spec, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(11), arenas)
    jstate, jobs = jax.jit(jenv.reset)(keys)
    pose0, goal0 = jax_reset_draw(jenv, keys, jnp.zeros((arenas, 44, 3)))
    state, obs = env.reset(arenas, pose0, goal0)
    for f in ("pose", "speed", "goal", "dist", "step", "dead"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)), atol=ATOL,
                                   err_msg=f)
    check_scans(env, obs.scans.numpy(), np.asarray(jobs.scans),
                pose0.numpy())

    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(5)
    events = np.zeros(4, int)
    for i in range(steps):
        act = rng.uniform([-0.2, -1.3], [1.2, 1.3],
                          (arenas, 44, 2)).astype(np.float32)
        if i == 0:
            jstate = _force_stage2_events(jstate)
            act[0, 0], act[0, 1], act[0, 6] = [1, 0], [0, 0], [1, 0]
            frozen = np.asarray(jstate.pose)[0, 20]
        rp, rg = jax_step_draw(jenv, jstate, jnp.asarray(act))
        state = to_torch_state(jstate)
        prev = state.scan_hist.numpy()
        ref = jstep(jstate, jnp.asarray(act))
        port = env.step(state, T(act), rp, rg)
        assert_step_matches_jax(env, prev, port, ref)
        jstate = ref[0]
        result = port[4].result.numpy()
        events += np.bincount(result.ravel(), minlength=4)
        if i == 0:
            new = port[0]
            assert (result[0, [0, 1]] == RESULT_CRASH).all()
            assert result[0, 6] == RESULT_GOAL
            assert result[0, 34] == RESULT_TIMEOUT
            assert not new.dead[0, 6:10].any() and not new.dead[0, 34:].any()
            assert (new.step[0, 6:10] == 0).all()
            assert new.dead[0, [0, 1, 20]].all()
            assert not port[4].valid[0, 20] and port[3][0, 20]
            np.testing.assert_array_equal(new.pose[0, 20].numpy(), frozen)
            np.testing.assert_allclose(new.pose[0, 7, :2].numpy(),
                                       [0.0, 16.0], atol=1e-5)
            assert float(port[2][0, 20]) == 0.0
    assert events[1:].all(), events


# ---------------------------------------------------------------------------
# behaviour, on the port alone (mirrors tests/test_env.py:162-212)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def env2():
    return Env(stage2(), device="cpu", seed=0)


def test_stage2_reset_uses_tables(env2):
    state, _ = env2.reset(1)
    pose = state.pose[0].numpy()
    np.testing.assert_allclose(pose[0], [-7.0, 11.5, np.pi], atol=1e-5)
    np.testing.assert_allclose(pose[33, :2], [-7.15, -13.53], atol=1e-5)
    xy = pose[34:, :2]
    assert ((xy[:, 0] >= 9) & (xy[:, 0] <= 19)).all()
    assert (((xy[:, 1] >= -5.0) & (xy[:, 1] <= -1.0))
            | ((xy[:, 1] >= -19.0) & (xy[:, 1] <= -13.0))).all()
    # stage-2 quirk: the first "previous distance" is 0 (stage_world2.py:170)
    assert not state.dist.any() and not state.dead.any()


def test_stage2_dead_robots_freeze_and_mask(env2):
    state, _ = env2.reset(1)
    dead = torch.zeros(1, 44, dtype=torch.bool)
    dead[0, 6] = True
    state = dataclasses.replace(state, dead=dead)
    p0 = state.pose[0, 6].clone()
    act = torch.tensor([1.0, 0.5]).expand(1, 44, 2)
    state, _, r, done, info = env2.step(state, act)
    assert torch.equal(state.pose[0, 6], p0)            # frozen
    assert float(r[0, 6]) == 0.0 and int(state.step[0, 6]) == 0
    assert not info.valid[0, 6] and done[0, 6]          # masked, latched
    assert info.valid[0, :6].all() and bool(state.dead[0, 6])
    assert torch.equal(state.speed[0, 6], torch.zeros(2))


def test_stage2_group_reset(env2):
    state, _ = env2.reset(1)
    dead = torch.zeros(1, 44, dtype=torch.bool)
    dead[0, 7:10] = True
    pose = state.pose.clone()
    g = state.goal[0, 6]
    pose[0, 6] = torch.stack([g[0] - 0.55, g[1], torch.tensor(0.0)])
    state = dataclasses.replace(state, dead=dead, pose=pose)
    act = torch.zeros(1, 44, 2)
    act[0, 6, 0] = 1.0
    state, _, _, done, info = env2.step(state, act)
    assert done[0, 6:10].all() and int(info.result[0, 6]) == RESULT_GOAL
    assert not state.dead[0, 6:10].any()    # the group reset, all alive again
    assert (state.step[0, 6:10] == 0).all()
    np.testing.assert_allclose(state.pose[0, 7, :2].numpy(), [0.0, 16.0],
                               atol=1e-5)
    assert not state.dist[0, 6:10].any()    # dist_prev_zero_on_reset


def test_stage2_dead_robot_waits_for_its_group(env2):
    """A robot that ends its episode before its group waits dead: it is not
    reset, and its later steps are masked."""
    state, _ = env2.reset(1)
    step = state.step.clone()
    step[0, 34] = 200
    pose = state.pose.clone()          # the corridor robots 1 m apart
    pose[0, 34:, 0] = 9.5 + torch.arange(10.0)
    pose[0, 34:, 1] = -3.0
    state = dataclasses.replace(state, step=step, pose=pose)
    zero = torch.zeros(1, 44, 2)
    state, _, _, done, info = env2.step(state, zero)
    assert int(info.result[0, 34]) == RESULT_TIMEOUT and done[0, 34]
    assert state.dead[0, 34] and not state.dead[0, 35:].any()
    p = state.pose[0, 34].clone()
    state, _, _, done, info = env2.step(state, zero)
    assert done[0, 34] and not info.valid[0, 34]
    assert int(info.result[0, 34]) == 0
    assert torch.equal(state.pose[0, 34], p)


# ---------------------------------------------------------------------------
# one stage-2 update against a JAX chain
# ---------------------------------------------------------------------------


def test_one_stage2_update_matches_jax_chain():
    """The stage-2 preset (4 epochs) warm-started from the stage-1 weights,
    one arena, horizon 8, minibatches of 88: group 1's robots time out one
    after another and the group resets inside the rollout, robot 20 times
    out and waits dead, so dead robots' steps cut GAE, count in the
    advantage normalization and train with weight 0, as in the JAX
    package.

    One element of two leaves drifts beyond the rules (on a CPU,
    JAX on XLA against the port in PyTorch; errors in units of lr = 5e-5):
    crt_fc1.weight (1,048,576 elements) 0.615 lr, 3.9% of the leaf's
    largest change, the next element 0.056 lr; actor2.weight (128) 0.0515
    lr, which takes the leaf to 1.09e-3 in relative 2-norm, the next
    element 3e-4 lr and the leaf 2.3e-5 without it.  Every other leaf
    holds both rules with all its elements (at most 9.0e-5 in relative
    2-norm, 0.058 lr in one element).  So one outlier a leaf."""
    cfg = TrainConfig.stage2(n_arenas=1, horizon=8)
    cfg.ppo = cfg.ppo._replace(batch_size=88)
    steps = np.zeros((1, 44), np.int32)
    steps[0, 6:10] = [195, 196, 197, 198]
    steps[0, 20] = 197
    model, params = jax_params(ROOT / "results" / "stage1_params.npz")
    metrics, jm = assert_one_update_matches_jax(
        cfg, JEnv(jget_world("stage2"), lidar_mode="xla"), model, params,
        steps, outliers=1)
    assert jm["episodes"] >= 5 and cfg.ppo.epochs == 4


@pytest.mark.parametrize("arenas", [1, 4])
def test_curriculum_presets_scale_the_batch(arenas):
    """As the JAX presets (tests/test_train.py:87): the minibatch scales
    with the arena count, stage 2 and the fine-tune take 4 epochs, and the
    fine-tune floors logstd at -2 on its own world."""
    s2 = TrainConfig.stage2(n_arenas=arenas)
    ft = TrainConfig.circle_ft(n_arenas=arenas)
    assert s2.world == "stage2" and ft.world == "circle_train"
    assert s2.ppo.batch_size == 512 * arenas and s2.ppo.epochs == 4
    assert ft.ppo.batch_size == 640 * arenas and ft.ppo.epochs == 4
    assert s2.ppo.logstd_min is None and ft.ppo.logstd_min == -2.0
    for c in (s2, ft):
        assert (c.horizon, c.ppo.clip_value, c.ppo.coeff_entropy,
                c.ppo.learning_rate) == (128, 0.1, 5e-4, 5e-5)


def test_cli_train_stage2(tmp_path):
    """train-stage2 --device cpu at a tiny size (the mini world, one update
    of 128 steps): its logs and a stage2_params.npz that the JAX package's
    loader reads."""
    cli.main(["train-stage2", "--world", "mini", "--arenas", "1",
              "--updates", "1", "--batch-size", "128", "--device", "cpu",
              "--log-dir", str(tmp_path)])
    assert (tmp_path / "metrics.csv").is_file()
    jax_params(tmp_path / "stage2_params.npz", beams=64)
