"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; every test skips where no CUDA card is visible.  This file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from rl_collision_avoidance_torch.engine.env import Env
from rl_collision_avoidance_torch.models import CNNPolicy
from rl_collision_avoidance_torch.ops import lidar_cuda, trunk_cuda
from rl_collision_avoidance_torch.worlds import mini, stage1

pytestmark = pytest.mark.gpu

LIDAR_ATOL = 1e-5
TRUNK_TOL = 1e-4  # absolute and relative; a 4096-long f32 sum in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _lidar_args(env):
    t = env.lidar_table
    return (env._lidar_cells, t.lo, t.cell, t.shape, env.local_dirs,
            env.spec.robot_radius, env.spec.max_range)


@pytest.mark.parametrize("make_spec,arenas", [(stage1, 16), (mini, 5)])
def test_lidar_kernel_matches_plain(cuda, make_spec, arenas):
    env = Env(make_spec(), device=cuda, seed=3)
    pose, _ = env.sample_pose_goal(arenas)
    before = lidar_cuda.launches
    got = lidar_cuda.lidar_obs(pose, *_lidar_args(env))
    assert lidar_cuda.launches == before + 1
    want = lidar_cuda.lidar_obs_plain(pose, *_lidar_args(env))
    torch.cuda.synchronize()
    assert got.shape == (arenas, env.n_robots, env.spec.n_beams)
    torch.testing.assert_close(got, want, atol=LIDAR_ATOL, rtol=0)


def test_lidar_kernel_rejects_bad_input(cuda):
    env = Env(mini(), device=cuda)
    pose, _ = env.sample_pose_goal(2)
    with pytest.raises(ValueError):
        lidar_cuda.lidar_obs(pose.double(), *_lidar_args(env))
    with pytest.raises(ValueError):
        lidar_cuda.lidar_obs(pose.transpose(0, 1), *_lidar_args(env))
    with pytest.raises(ValueError):
        lidar_cuda.lidar_obs(pose, env._lidar_cells.cpu(),
                             *_lidar_args(env)[1:])


@pytest.mark.parametrize("batch", [1, 37, 3072])
def test_trunk_kernel_matches_plain(cuda, batch):
    torch.manual_seed(batch)
    policy = CNNPolicy().to(cuda)
    scans = torch.rand(batch, 3, 512, device=cuda) - 0.5
    act, crt = policy.trunk_weights("act"), policy.trunk_weights("crt")
    with torch.no_grad():
        before = trunk_cuda.launches
        got = trunk_cuda.twin_trunks(scans, act, crt)
        assert trunk_cuda.launches == before + 1
        want = trunk_cuda.twin_trunks_plain(scans, act, crt)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=TRUNK_TOL, rtol=TRUNK_TOL)


def test_trunk_kernel_refuses_autograd(cuda):
    policy = CNNPolicy().to(cuda)
    scans = torch.zeros(4, 3, 512, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        trunk_cuda.twin_trunks(scans, policy.trunk_weights("act"),
                               policy.trunk_weights("crt"))


def test_env_kernel_path_matches_plain_path(cuda):
    """Five steps of the same state, actions and reset draws through the
    kernel path and the plain path on the card."""
    env = Env(stage1(), device=cuda, seed=0)
    plain = Env(stage1(), device=cuda, use_kernels=False)
    pose, goal = env.sample_pose_goal(8)
    state, obs = env.reset(8, pose, goal)
    pstate, pobs = plain.reset(8, pose, goal)
    torch.testing.assert_close(obs.scans, pobs.scans, atol=LIDAR_ATOL, rtol=0)
    g = torch.Generator(device=cuda).manual_seed(1)
    for _ in range(5):
        act = torch.rand((8, 24, 2), generator=g, device=cuda) * 2 - 0.5
        rp, rg = env.sample_pose_goal(8)
        state, obs, r, d, _ = env.step(state, act, rp, rg)
        pstate, pobs, pr, pd, _ = plain.step(pstate, act, rp, rg)
        assert torch.equal(r, pr) and torch.equal(d, pd)
        assert torch.equal(state.pose, pstate.pose)
        torch.testing.assert_close(obs.scans, pobs.scans, atol=LIDAR_ATOL,
                                   rtol=0)
