"""The rule that chooses the env-step kernels (ops/env_cuda.py) and the
constants they are given, on the CPU: the CPU, ``use_kernels=False`` and
rect worlds keep the plain chain.  The kernels themselves run on the card
(tests/test_torch_gpu.py::test_env_kernel_path_matches_plain_path)."""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from rl_collision_avoidance_torch.engine.env import Env
from rl_collision_avoidance_torch.ops import env_cuda
from rl_collision_avoidance_torch.worlds import get_world
from rl_collision_avoidance_torch.worlds.spec import ResetMode


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("footprint", ["disc", "rect"])
def test_kernel_path_rule(device, use_kernels, footprint):
    want = device.startswith("cuda") and use_kernels and footprint == "disc"
    assert env_cuda.kernel_path(torch.device(device), use_kernels,
                                footprint) is want
    assert env_cuda.kernel_path(device, use_kernels, footprint) is want


@pytest.mark.parametrize("world", ["mini", "stage1_rect"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_cpu_env_steps_through_the_plain_chain(monkeypatch, world,
                                               use_kernels):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU env launched an env-step kernel")

    monkeypatch.setattr(env_cuda, "physics", refuse)
    monkeypatch.setattr(env_cuda, "reset_apply", refuse)
    monkeypatch.setattr(env_cuda, "sample", refuse)
    env = Env(get_world(world), device="cpu", seed=1, use_kernels=use_kernels)
    assert env._kernels is None
    state, _ = env.reset(2)
    act = torch.full((2, env.n_robots, 2), 0.5)
    state, _, reward, done, _ = env.step(state, act)
    assert reward.shape == done.shape == (2, env.n_robots)


@pytest.mark.parametrize("world", ["stage1", "stage2", "circle",
                                   "circle_train", "mini"])
def test_kernel_constants(world):
    """The constants the kernels read, as the plain chain rounds them to
    float32, with dense group ids where groups reset together, and the
    reset sampler's: the tables where the world has them, the disc's
    radius, dmin^2 and dmax^2 - dmin^2 as Python computes them and PyTorch
    rounds them, and the jitter."""
    spec = get_world(world)
    env = Env(spec, device="cpu")
    w = env_cuda.world(spec, env._wall_cells, env.wall_table)
    c = w.consts
    assert ctypes.sizeof(env_cuda.EnvConsts) == 120
    f32 = lambda x: float(np.float32(x))
    t = env.wall_table
    assert (c.wall, c.k, c.nx, c.ny) == (env._wall_cells.data_ptr(), t.k,
                                         *t.shape)
    assert (c.lo_x, c.lo_y, c.inv_cell) == (f32(t.lo[0]), f32(t.lo[1]), 1.0)
    assert (c.n, c.mode, c.substeps, c.timeout, c.dist_zero) == (
        spec.n_robots, spec.reset_mode.value, spec.substeps, spec.timeout,
        int(spec.dist_prev_zero_on_reset))
    assert (c.h, c.radius_sq, c.diam_sq, c.goal_size, c.omega) == (
        f32(spec.dt / spec.substeps), f32(spec.robot_radius ** 2),
        f32((2 * spec.robot_radius) ** 2), f32(spec.goal_size),
        f32(spec.omega_thresh))
    assert w.fixed == (spec.reset_mode is ResetMode.FIXED_TABLES)
    dmin, dmax = spec.goal_dist_min, spec.goal_dist_max
    assert (c.n_fixed, c.spawn_r, c.dmin_sq, c.d_span, c.jitter) == (
        spec.n_fixed, f32(spec.spawn_radius), f32(dmin * dmin),
        f32(dmax * dmax - dmin * dmin), f32(spec.pose_jitter))
    if spec.reset_mode is ResetMode.RANDOM_DISC:
        assert w.tables is None and c.pose_table is c.goal_table is None
    else:
        for t, table, ptr in zip(w.tables, (spec.init_pose_table,
                                            spec.goal_table),
                                 (c.pose_table, c.goal_table)):
            assert t.dtype == torch.float32 and t.is_contiguous()
            assert ptr == t.data_ptr() and np.array_equal(t.numpy(), table)
    if spec.reset_mode is ResetMode.TABLES_THEN_CORRIDOR:
        ids = w.group_id.tolist()
        assert c.group_id == w.group_id.data_ptr()
        assert sorted(set(ids)) == list(range(len(set(ids))))
        same = np.equal.outer(spec.group_id, spec.group_id)
        assert (np.equal.outer(ids, ids) == same).all()
    else:
        assert w.group_id is None and c.group_id is None


def test_kernel_refuses_too_many_robots():
    spec = dataclasses.replace(get_world("mini"), n_robots=1025)
    env = Env(get_world("mini"), device="cpu")
    with pytest.raises(ValueError, match="1025"):
        env_cuda.world(spec, env._wall_cells, env.wall_table)


def _sample_case(world, a=2, drop=None, **change):
    """A world's kernel view and the uniforms Env._draw makes for ``a``
    arenas on the CPU, with input ``drop`` left out and ``change``'s
    replaced."""
    env = Env(get_world(world), device="cpu", seed=1)
    w = env_cuda.world(env.spec, env._wall_cells, env.wall_table)
    u = dict(zip(("u_pose", "u_goal", "u_jitter"), env._draw(a)),
             cur_pose=torch.zeros((a, env.n_robots, 3)))
    if drop:
        u[drop] = None
    u.update(change)
    return w, a, u


@pytest.mark.parametrize("world,drop,change,refusal", [
    ("circle", None, {}, "FIXED_TABLES"),
    ("stage1", "u_goal", {}, "uniforms"),
    ("stage1", None, {"u_pose": torch.zeros((3, 2, 24, 32))}, "uniforms"),
    ("stage1", None, {"cur_pose": torch.zeros((2, 24, 2))}, "uniforms"),
    ("stage2", None, {"u_goal": torch.zeros((2, 2, 44, 32),
                                            dtype=torch.float64)},
     "uniforms"),
    ("stage2", None, {"u_jitter": torch.zeros((2, 44, 2))}, "uniforms"),
    ("circle_train", "u_jitter", {}, "uniforms"),
    ("circle_train", None, {"u_pose": torch.zeros((3, 2, 50, 32))},
     "uniforms")])
def test_sampler_kernel_refuses_bad_uniforms(world, drop, change, refusal):
    """env_cuda.sample checks its uniforms against the world before any
    launch: a FIXED_TABLES world, a draw missing, of another shape, dtype
    or kind than the world's reset mode makes, or one it does not make."""
    w, a, u = _sample_case(world, drop=drop, **change)
    with pytest.raises(ValueError, match=refusal):
        env_cuda.sample(w, a, **u)
