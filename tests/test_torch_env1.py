"""The port's single-arena conveniences Env.reset1 / Env.step1: bit-equal
to reset(1) / step on a batch of one, and against the JAX package's
reset1 / step1 with the same state, actions and reset draws
(tests/torch_parity.py's step rule)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.engine.env import Env as JEnv
from rl_collision_avoidance_tpu.worlds import stage1 as jstage1

from rl_collision_avoidance_torch.engine.env import Env
from rl_collision_avoidance_torch.worlds import get_world, stage1
from torch_parity import (ATOL, assert_step_matches_jax, check_scans,
                          jax_reset_draw, jax_step_draw, to_torch_state)

STEPS = 4


def _arena(x):
    """``x`` (a tensor or a state/obs/info record) with an arena axis."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: getattr(x, f.name)[None]
                                         for f in dataclasses.fields(x)})
    return x[None]


def _assert_same(one, batched, what):
    """``one`` (no arena axis) bit-equal to arena 0 of ``batched``."""
    if dataclasses.is_dataclass(one):
        for f in dataclasses.fields(one):
            _assert_same(getattr(one, f.name), getattr(batched, f.name),
                         f"{what}.{f.name}")
        return
    assert one.dtype == batched.dtype, what
    assert torch.equal(one, batched[0]), what


@pytest.mark.parametrize("world", ["stage1", "stage2", "circle_train"])
def test_reset1_step1_are_a_batch_of_one(world):
    """Two envs of one seed: reset1 / step1 of one against reset(1) / step
    of the other, drawing from their generators (episode resets
    included: the actions drive robots into walls and each other)."""
    spec = get_world(world)
    one, many = (Env(spec, device="cpu", seed=3) for _ in range(2))
    s1, o1 = one.reset1()
    s, o = many.reset(1)
    _assert_same(s1, s, "state")
    _assert_same(o1, o, "obs")
    rng = np.random.default_rng(0)
    for i in range(STEPS):
        act = torch.from_numpy(rng.uniform(
            [0.8, -1.3], [1.2, 1.3], (spec.n_robots, 2)).astype(np.float32))
        out1 = one.step1(s1, act)
        out = many.step(s, act[None])
        for name, a, b in zip(("state", "obs", "reward", "done", "info"),
                              out1, out):
            _assert_same(a, b, f"step {i} {name}")
        s1, s = out1[0], out[0]
    assert out1[2].shape == (spec.n_robots,)


def test_reset1_step1_match_jax():
    """The JAX package's reset1(key) / step1(state, action) against the
    port's with the JAX draws injected (reset1(pose, goal), step1(...,
    reset_pose, reset_goal)), from the same state at every step."""
    jenv = JEnv(jstage1(), lidar_mode="xla")
    env = Env(stage1(), device="cpu")
    key = jax.random.PRNGKey(7)
    jstate, jobs = jax.jit(jenv.reset1)(key)
    pose0, goal0 = jax_reset_draw(jenv, key[None],
                                  jnp.zeros((1, env.n_robots, 3)))
    state, obs = env.reset1(pose0[0], goal0[0])
    assert state.pose.shape == (env.n_robots, 3)
    for f in ("pose", "speed", "goal", "dist", "step"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)), atol=ATOL,
                                   err_msg=f)
    check_scans(env, obs.scans[None].numpy(), np.asarray(jobs.scans)[None],
                pose0.numpy())

    jstep = jax.jit(jenv.step1)
    batch = lambda t: jax.tree_util.tree_map(lambda x: x[None], t)
    rng = np.random.default_rng(3)
    for _ in range(STEPS):
        act = rng.uniform([-0.2, -1.3], [1.2, 1.3],
                          (env.n_robots, 2)).astype(np.float32)
        rp, rg = jax_step_draw(jenv, batch(jstate), jnp.asarray(act)[None])
        state = to_torch_state(jstate)
        prev = state.scan_hist[None].numpy()
        port = env.step1(state, torch.from_numpy(act), rp[0], rg[0])
        ref = jstep(jstate, jnp.asarray(act))
        assert_step_matches_jax(env, prev, tuple(map(_arena, port)),
                                batch(ref))
        jstate = ref[0]
