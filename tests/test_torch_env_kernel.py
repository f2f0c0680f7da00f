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
    float32, with dense group ids where groups reset together."""
    spec = get_world(world)
    env = Env(spec, device="cpu")
    w = env_cuda.world(spec, env._wall_cells, env.wall_table)
    c = w.consts
    assert ctypes.sizeof(env_cuda.EnvConsts) == 80
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
