"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; every test skips where no CUDA card is visible.  This file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import gc
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from rl_collision_avoidance_torch.algo import PPOConfig
from rl_collision_avoidance_torch.engine.env import Env, EnvState
from rl_collision_avoidance_torch.models import CNNPolicy
from rl_collision_avoidance_torch.ops import env_cuda, lidar_cuda, trunk_cuda
from rl_collision_avoidance_torch.train import TrainConfig, Trainer
from rl_collision_avoidance_torch.utils import graphs
from rl_collision_avoidance_torch.worlds import (circle, circle_train,
                                                 get_world, mini, stage1,
                                                 stage1_rect, stage2)

pytestmark = pytest.mark.gpu

RESULTS = Path(__file__).resolve().parents[1] / "results"
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


@pytest.mark.parametrize("make_spec,arenas", [(stage1, 16), (mini, 5),
                                              (stage2, 16), (circle, 1),
                                              (circle, 32),
                                              (circle_train, 16)])
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


@pytest.mark.parametrize("make_spec,n", [(stage1, 24), (stage1, 50),
                                         (stage2, 44), (circle, 50)])
def test_lidar_kernel_on_adversarial_arena(cuda, make_spec, n):
    """The culling rules' edge cases (lidar_cuda.adversarial_poses) on the
    stage-1 walls with 24 robots and with 50 (more than a warp), on the
    stage-2 map (K = 72 candidate slots) with 44 and in the 60 m rink with
    50: within LIDAR_ATOL of the plain version, and bit-equal over two
    launches."""
    env = Env(make_spec(), device=cuda)
    s = env.spec
    base = torch.from_numpy(lidar_cuda.adversarial_poses(s, n,
                                                         seed=n)).to(cuda)
    shift = env.sample_pose_goal(1)[0][0, 0]     # one seeded spawn pose
    pose = torch.cat([base, base + shift]).contiguous()
    got = lidar_cuda.lidar_obs(pose, *_lidar_args(env))
    again = lidar_cuda.lidar_obs(pose, *_lidar_args(env))
    want = lidar_cuda.lidar_obs_plain(pose, *_lidar_args(env))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (want < 0.5 / s.max_range - 0.5).any()   # a disc inside 0.5 m
    torch.testing.assert_close(got, want, atol=LIDAR_ATOL, rtol=0)


def _rect_circle():
    return dataclasses.replace(circle(), footprint="rect")


@pytest.mark.parametrize("make_spec,arenas", [(stage1_rect, 32),
                                              (_rect_circle, 1),
                                              (_rect_circle, 16)])
def test_lidar_walls_only_kernel_matches_plain(cuda, make_spec, arenas):
    """The walls-only mode (discs=False) against lidar_obs_plain(discs=
    False) on seeded poses with an adversarial_poses arena last: within
    LIDAR_ATOL, bit-equal over two launches, counted as walls-only."""
    env = Env(make_spec(), device=cuda, seed=5)
    s = env.spec
    pose, _ = env.sample_pose_goal(arenas)
    pose[-1] = torch.from_numpy(lidar_cuda.adversarial_poses(
        s, s.n_robots, seed=arenas))[0].to(cuda)
    pose = pose.contiguous()
    key = ("lidar_obs_walls", arenas * s.n_robots, "float32")
    before = lidar_cuda.launches_by_mode[key]
    got = lidar_cuda.lidar_obs(pose, *_lidar_args(env), discs=False)
    again = lidar_cuda.lidar_obs(pose, *_lidar_args(env), discs=False)
    want = lidar_cuda.lidar_obs_plain(pose, *_lidar_args(env), discs=False)
    full = lidar_cuda.lidar_obs(pose, *_lidar_args(env))
    torch.cuda.synchronize()
    assert lidar_cuda.launches_by_mode[key] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=LIDAR_ATOL, rtol=0)
    assert (got >= full).all() and (got > full).any()   # no disc


@pytest.mark.parametrize("make_spec,kw", [(stage1_rect, {}),
                                          (_rect_circle, {}),
                                          (_rect_circle, {"disc_cull_k": 12})])
def test_rect_env_kernel_path_matches_plain_path(cuda, make_spec, kw):
    """Five steps of the box footprint through the walls-only kernel and
    the plain path on the card, from the same state, actions and reset
    draws: poses, rewards and flags equal, scans within LIDAR_ATOL."""
    env = Env(make_spec(), device=cuda, seed=0, **kw)
    plain = Env(make_spec(), device=cuda, use_kernels=False, **kw)
    assert env.walls_only
    n = env.n_robots
    pose, goal = env.sample_pose_goal(4)
    state, obs = env.reset(4, pose, goal)
    pstate, pobs = plain.reset(4, pose, goal)
    torch.testing.assert_close(obs.scans, pobs.scans, atol=LIDAR_ATOL, rtol=0)
    g = torch.Generator(device=cuda).manual_seed(1)
    counts = lidar_cuda.launches_by_mode.copy()
    for _ in range(5):
        act = torch.rand((4, n, 2), generator=g, device=cuda) * 2 - 0.5
        rp, rg = env.sample_pose_goal(4, state.pose)
        state, obs, r, d, _ = env.step(state, act, rp, rg)
        pstate, pobs, pr, pd, _ = plain.step(pstate, act, rp, rg)
        assert torch.equal(r, pr) and torch.equal(d, pd)
        assert torch.equal(state.pose, pstate.pose)
        torch.testing.assert_close(obs.scans, pobs.scans, atol=LIDAR_ATOL,
                                   rtol=0)
    new = lidar_cuda.launches_by_mode - counts
    assert dict(new) == {("lidar_obs_walls", 4 * n, "float32"): 5}


def test_disc_cull_kernel_walls_match_exact_kernel(cuda):
    """disc_cull_k on a disc world: the walls-only kernel with the top-k
    discs; at k = N - 1 within LIDAR_ATOL of the exact kernel (walls and
    discs in one launch), and on robots spread beyond max_range at k = 4
    too."""
    spec = stage1()
    n = spec.n_robots
    exact = Env(spec, device=cuda)
    cluster = torch.rand((8, n, 3), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda) * 8 - 4
    ang = torch.linspace(0, 2 * torch.pi, n + 1, device=cuda)[:n]
    ring = torch.stack([9 * ang.cos(), 9 * ang.sin(), ang], -1)[None]
    for k, pose in ((n - 1, cluster), (4, ring.contiguous())):
        culled = Env(spec, device=cuda, disc_cull_k=k)
        assert culled.walls_only
        torch.testing.assert_close(culled.scan_obs(pose), exact.scan_obs(pose),
                                   atol=LIDAR_ATOL, rtol=0)


def test_lidar_kernel_rejects_bad_input(cuda):
    env = Env(mini(), device=cuda)
    pose, _ = env.sample_pose_goal(2)
    args = _lidar_args(env)
    with pytest.raises(ValueError):
        lidar_cuda.lidar_obs(pose.double(), *args)
    with pytest.raises(ValueError):
        lidar_cuda.lidar_obs(pose.transpose(0, 1), *args)
    with pytest.raises(ValueError):
        lidar_cuda.lidar_obs(pose, env._lidar_cells.cpu(), *args[1:])
    with pytest.raises(ValueError):         # table rows against the grid
        lidar_cuda.lidar_obs(pose, env._lidar_cells[1:], *args[1:])
    table = env._lidar_cells
    shifted = torch.empty(table.numel() + 1, device=cuda)[1:].view(
        table.shape).copy_(table)
    with pytest.raises(ValueError):         # table not 16-byte aligned
        lidar_cuda.lidar_obs(pose, shifted, *args[1:])
    with pytest.raises(ValueError):         # dirs of the wrong last dim
        lidar_cuda.lidar_obs(pose, *args[:4], env.local_dirs[:, :1],
                             *args[5:])


@pytest.mark.parametrize("batch", [1, 37, 50, 704, 768, 1000, 3072, 8192,
                                   10240])
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


def test_trunk_kernel_is_deterministic(cuda):
    """No float atomics in the split-K sums: two launches agree bit for
    bit, at a batch whose fc1 is split (768) and one whose is not."""
    for batch in (768, 4099):
        scans, act, crt, _ = _bwd_inputs(cuda, batch, seed=3)
        with torch.no_grad():
            first = trunk_cuda.twin_trunks(scans, act, crt)
            second = trunk_cuda.twin_trunks(scans, act, crt)
        assert torch.equal(first, second)


@pytest.mark.parametrize("batch", [1, 37, 50, 704, 768, 800, 1600, 3072,
                                   4099, 8192, 10240, 32768])
def test_trunk_workspace_plan_matches_the_kernels(cuda, batch):
    """The wrapper's workspace sizes equal the launchers' own counts."""
    fwd, bwd = trunk_cuda.workspace_counters()
    for precision in trunk_cuda.PRECISIONS:
        pl = trunk_cuda.plan_for(torch.empty(batch, 3, 512, device=cuda),
                                 precision)
        assert fwd(batch, 3, 512, pl.fc1_splits,
                   precision == "bf16") == pl.fwd_workspace
        assert bwd(batch, 3, 512, pl.conv_blocks, pl.fc1_splits,
                   pl.dwf_splits, precision == "bf16") == pl.bwd_workspace


def test_trunk_kernel_refuses_unsupported_scans(cuda):
    """Beam counts that are not a multiple of 16, or more frames than the
    kernels keep sums for, raise instead of falling back."""
    scans = torch.zeros(4, 3, 500, device=cuda)
    policy = CNNPolicy(beams=500).to(cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="multiple of 16"):
        trunk_cuda.twin_trunks(scans, policy.trunk_weights("act"),
                               policy.trunk_weights("crt"))


def test_trunk_kernel_refuses_autograd(cuda):
    """The trunk kernels give the weights a gradient but not the scans."""
    policy = CNNPolicy().to(cuda)
    scans = torch.zeros(4, 3, 512, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient to the scans"):
        trunk_cuda.twin_trunks(scans, policy.trunk_weights("act"),
                               policy.trunk_weights("crt"))


def _bwd_inputs(cuda, batch, seed=0):
    torch.manual_seed(seed)
    policy = CNNPolicy().to(cuda)
    scans = torch.rand(batch, 3, 512, device=cuda) - 0.5
    g = torch.randn(2, batch, 256, device=cuda)
    act = [w.detach() for w in policy.trunk_weights("act")]
    crt = [w.detach() for w in policy.trunk_weights("crt")]
    return scans, act, crt, g


@pytest.mark.parametrize("batch", [37, 1000])
def test_trunk_bwd_kernel_matches_plain(cuda, batch):
    """Against the plain version in float64; each leaf at 1e-5 of its
    largest value (its batch sums run in another order than cuDNN's)."""
    scans, act, crt, g = _bwd_inputs(cuda, batch)
    before = trunk_cuda.bwd_launches
    got = trunk_cuda.twin_trunks_grads(scans, act, crt, g)
    assert trunk_cuda.bwd_launches == before + 1
    f64 = lambda ws: [w.double() for w in ws]
    want = trunk_cuda.twin_trunks_grads_plain(scans.double(), f64(act),
                                              f64(crt), g.double())
    torch.cuda.synchronize()
    for name, a, b in zip(trunk_cuda.WEIGHT_NAMES * 2, (*got[0], *got[1]),
                          (*want[0], *want[1])):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        scale = float(b.abs().max())
        torch.testing.assert_close(a.double(), b, atol=1e-5 * scale, rtol=0,
                                   msg=name)


@pytest.mark.parametrize("batch", [37, 50, 704, 1000, 4099, 8192, 10240])
def test_trunk_bwd_kernel_within_rounding_limit(cuda, batch):
    """Against the plain version in float64 at batches ragged against the
    128-sample tiles, the split-K ranges and the conv blocks, held as
    chip_smoke.py holds B = 32,768: each gradient element within BWD_TOL of
    the sum of its terms' absolute values, plus the whole terms behind fc1
    ReLUs that float32 may turn either way (at B = 4,099 one such flip moves
    a conv gradient by ~1e-3 of its largest value, far above 1e-5 of it, in
    the kernel and not in cuBLAS, whose sums round otherwise)."""
    import chip_smoke

    scans, act, crt, g = _bwd_inputs(cuda, batch)
    got = trunk_cuda.twin_trunks_grads(scans, act, crt, g)
    f64 = lambda ws: [w.double() for w in ws]
    want = trunk_cuda.twin_trunks_grads_plain(scans.double(), f64(act),
                                              f64(crt), g.double())
    limits = chip_smoke.trunk_grads_limits(scans, act, crt, g)
    torch.cuda.synchronize()
    for t in range(2):
        for name, a, b, scale, near in zip(trunk_cuda.WEIGHT_NAMES, got[t],
                                           want[t], *limits[t]):
            limit = chip_smoke.BWD_TOL * scale + near
            assert bool(torch.isfinite(a).all()), name
            assert bool(((a.double() - b).abs() <= limit).all()), (t, name)


@pytest.mark.parametrize("frames,beams", [(3, 64), (1, 16), (6, 128)])
def test_trunk_kernels_other_scan_shapes(cuda, frames, beams):
    """The kernels take 1-6 frames and beam counts that are multiples of 16
    (the mini world has 64 beams): forward and backward against the plain
    versions, with the tolerances of the stage-1 tests above."""
    import chip_smoke

    torch.manual_seed(frames * beams)
    policy = CNNPolicy(frames=frames, beams=beams).to(cuda)
    scans = torch.rand(45, frames, beams, device=cuda) - 0.5
    g = torch.randn(2, 45, 256, device=cuda)
    act = [w.detach() for w in policy.trunk_weights("act")]
    crt = [w.detach() for w in policy.trunk_weights("crt")]
    with torch.no_grad():
        got = trunk_cuda.twin_trunks(scans, act, crt)
        want = trunk_cuda.twin_trunks_plain(scans, act, crt)
    torch.testing.assert_close(got, want, atol=TRUNK_TOL, rtol=TRUNK_TOL)
    grads = trunk_cuda.twin_trunks_grads(scans, act, crt, g)
    f64 = lambda ws: [w.double() for w in ws]
    ref = trunk_cuda.twin_trunks_grads_plain(scans.double(), f64(act),
                                             f64(crt), g.double())
    limits = chip_smoke.trunk_grads_limits(scans, act, crt, g)
    torch.cuda.synchronize()
    for t in range(2):
        for name, a, b, scale, near in zip(trunk_cuda.WEIGHT_NAMES, grads[t],
                                           ref[t], *limits[t]):
            assert bool(((a.double() - b).abs()
                         <= chip_smoke.BWD_TOL * scale + near).all()), name


def test_trunk_bwd_kernel_is_deterministic(cuda):
    """No float atomics: two launches on the same inputs agree bit for bit."""
    scans, act, crt, g = _bwd_inputs(cuda, 1000, seed=1)
    first = trunk_cuda.twin_trunks_grads(scans, act, crt, g)
    second = trunk_cuda.twin_trunks_grads(scans, act, crt, g)
    for a, b in zip((*first[0], *first[1]), (*second[0], *second[1])):
        assert torch.equal(a, b)


def test_policy_grads_through_kernels_match_plain_path(cuda):
    """The autograd Function (both kernels) against autograd through the
    plain trunks, on a loss touching both heads and logstd; 1e-4 of each
    leaf's largest value, the forward kernel's own tolerance."""
    torch.manual_seed(2)
    policy = CNNPolicy().to(cuda)
    scans = torch.rand(37, 3, 512, device=cuda) - 0.5
    goal, speed = torch.randn(37, 2, device=cuda), torch.randn(37, 2,
                                                               device=cuda)

    def loss(feats):
        v, m, ls = policy.heads(feats, goal, speed)
        return (v ** 2).sum() + (m ** 2).sum() + (ls ** 2).sum()

    act, crt = policy.trunk_weights("act"), policy.trunk_weights("crt")
    params = list(policy.parameters())
    before = (trunk_cuda.launches, trunk_cuda.bwd_launches)
    got = torch.autograd.grad(loss(trunk_cuda.twin_trunks(scans, act, crt)),
                              params)
    assert (trunk_cuda.launches, trunk_cuda.bwd_launches) == (before[0] + 1,
                                                              before[1] + 1)
    with trunk_cuda.exact_float32():
        want = torch.autograd.grad(
            loss(trunk_cuda.twin_trunks_plain(scans, act, crt)), params)
    for (name, _), a, b in zip(policy.named_parameters(), got, want):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=0, msg=name)


def _step_fields(out) -> dict:
    """(state', obs', reward, done, info) of ``Env.step`` by field name."""
    state, obs, reward, done, info = out
    return {**{f"state.{f.name}": getattr(state, f.name)
               for f in dataclasses.fields(state)},
            **{f"obs.{f.name}": getattr(obs, f.name)
               for f in dataclasses.fields(obs)},
            "reward": reward, "done": done,
            **{f"info.{f.name}": getattr(info, f.name)
               for f in dataclasses.fields(info)}}


def _on_the_edges(env, state, arena: int):
    """``state`` with, in ``arena``, robots on the step's thresholds (they
    get action 0 from ``_edge_actions``, so they stay where they are):
    robot 0 exactly ``goal_size`` from its goal and robot 1 just inside it,
    robots 2 and 3 exactly two radii apart and robots 4 and 5 a hair
    closer, robot 6 one radius from the wall's nearest point; robot 7 at
    the timeout and robot 8 one step short of it; robots 9-11 dead."""
    spec, r = env.spec, env.spec.robot_radius
    pose, goal = state.pose.clone(), state.goal.clone()
    step, dead = state.step.clone(), state.dead.clone()
    g = spec.goal_size
    for i, off in ((0, g), (1, float(np.nextafter(np.float32(g), 0)))):
        goal[arena, i] = pose[arena, i, :2] + torch.tensor([off, 0.0],
                                                           device=pose.device)
    for i, gap in ((2, 2 * r), (4, 2 * r * (1 - 1e-6))):
        pose[arena, i + 1, :2] = pose[arena, i, :2] + torch.tensor(
            [gap, 0.0], device=pose.device)
    valid = np.asarray(spec.seg_valid, bool)
    p0 = np.asarray(spec.seg_p, np.float64)[valid][0]    # the first wall
    e = np.asarray(spec.seg_e, np.float64)[valid][0]
    normal = np.array([-e[1], e[0]]) / np.hypot(*e)
    pose[arena, 6, :2] = torch.tensor(p0 + 0.5 * e + r * normal,
                                      device=pose.device)
    step[arena, 7] = spec.timeout
    step[arena, 8] = spec.timeout - 1
    dead[arena, 9:12] = True
    dist = torch.linalg.vector_norm(goal - pose[..., :2], dim=-1)
    return dataclasses.replace(state, pose=pose, goal=goal, step=step,
                               dead=dead, dist=dist)


def _edge_actions(act, arena: int):
    act = act.clone()
    act[arena, :9] = 0.0
    return act


#: (world, arenas, reset draws injected, obs dtype): the curriculum's
#: worlds with their reset modes (stage 1 per robot, stage 2 and
#: circle_train by group, circle never), with the tests' reset draws and
#: with the env's own generator (the same seed on both paths, so the
#: same draws), and bf16 scans.
ENV_CASES = [(stage1, 8, True, None), (stage1, 8, False, None),
             (stage2, 4, True, None), (stage2, 4, False, None),
             (circle, 4, True, None), (circle_train, 3, True, None),
             (circle_train, 3, False, None),
             (stage1, 4, False, torch.bfloat16)]


@pytest.mark.parametrize("make_spec,arenas,inject,obs_dtype", ENV_CASES)
def test_env_kernel_path_matches_plain_path(cuda, make_spec, arenas, inject,
                                            obs_dtype):
    """240 chained steps of the kernel path (``ops/env_cuda.py``) and of
    ``use_kernels=False`` on the card from the same start, each path on its
    own states: every bool and int field equal and every float field of
    the env step bit-equal at every step (the scans, from the lidar kernel
    and its plain version, within LIDAR_ATOL, and bf16 scans within one
    bf16 ulp more).  Actions run out of their
    bounds; every 40 steps the last arena gets robots on the thresholds
    (``_on_the_edges``), and every 60 steps the first arena times out as a
    whole, so that stage 2's and circle_train's groups reset.  The kernel
    path leaves its input state as it was."""
    env = Env(make_spec(), device=cuda, seed=0, obs_dtype=obs_dtype)
    plain = Env(make_spec(), device=cuda, seed=0, use_kernels=False,
                obs_dtype=obs_dtype)
    assert env._kernels is not None and plain._kernels is None
    n = env.n_robots
    state, _ = env.reset(arenas)
    pstate, _ = plain.reset(arenas)
    g = torch.Generator(device=cuda).manual_seed(1)
    counts = env_cuda.launches_by_mode.copy()
    resets = 0
    for t in range(240):
        act = torch.rand((arenas, n, 2), generator=g, device=cuda) * 4 - 1.5
        if t % 40 == 20:
            state = _on_the_edges(env, state, arenas - 1)
            pstate = _on_the_edges(plain, pstate, arenas - 1)
            act = _edge_actions(act, arenas - 1)
        if t % 60 == 30:
            state = dataclasses.replace(state, step=torch.where(
                torch.arange(arenas, device=cuda)[:, None] == 0,
                env.spec.timeout, state.step))
            pstate = dataclasses.replace(pstate, step=state.step.clone())
        draw = ((None, None) if not inject
                else env.sample_pose_goal(arenas, state.pose))
        before = {k: v.clone() for k, v in vars(state).items()}
        got = _step_fields(env.step(state, act, *draw))
        want = _step_fields(plain.step(pstate, act, *draw))
        for k, v in vars(state).items():
            assert torch.equal(v, before[k]), f"step {t}: {k} was written"
        for k, w in want.items():
            v = got[k]
            assert v.dtype == w.dtype and v.shape == w.shape, k
            if k in ("state.scan_hist", "obs.scans"):
                # the two lidars agree within LIDAR_ATOL in float32; bf16
                # scans may round such a pair one bf16 ulp apart
                ulp = 2.0 ** -7 if obs_dtype == torch.bfloat16 else 0.0
                assert bool(((v.float() - w.float()).abs() <= LIDAR_ATOL
                             + ulp * w.float().abs()).all()), k
            else:
                assert torch.equal(v, w), f"step {t}: {k} differs"
        state, pstate = (EnvState(**{k[6:]: v for k, v in out.items()
                                     if k.startswith("state.")})
                         for out in (got, want))
        resets += int((state.step == 0).sum())
    torch.cuda.synchronize()
    fixed = make_spec().reset_mode.name == "FIXED_TABLES"
    robots = arenas * n
    assert env_cuda.launches_by_mode["env_physics", robots, "float32"] \
        - counts["env_physics", robots, "float32"] == 240
    assert env_cuda.launches_by_mode["env_reset", robots, "float32"] \
        - counts["env_reset", robots, "float32"] == (0 if fixed else 240)
    assert fixed or resets > 0


def test_training_update_on_the_card(cuda):
    """One stage-1 update (2 arenas, horizon 16: 768 samples, 3 minibatches
    x 2 epochs) through all three kernels, with finite losses."""
    tr = Trainer(TrainConfig.stage1(n_arenas=2, horizon=16,
                                    ppo=PPOConfig(batch_size=256)),
                 device=cuda)
    state = tr.init_state()
    before = [p.detach().clone() for p in state.policy.parameters()]
    counts = (lidar_cuda.launches, trunk_cuda.launches,
              trunk_cuda.bwd_launches, env_cuda.launches, graphs.captures,
              graphs.replays)
    state, m = tr.train_step(state)
    assert lidar_cuda.launches - counts[0] == 16
    assert env_cuda.launches - counts[3] == 2 * 16   # physics and reset
    # the acting step: one capture, after its warm-up runs, and 16 replays,
    # each launching the forward; then the bootstrap and PPO
    assert (graphs.captures - counts[4], graphs.replays - counts[5]) == (1, 16)
    assert trunk_cuda.launches - counts[1] == graphs.WARMUP + 16 + 1 + 6
    assert trunk_cuda.bwd_launches - counts[2] == 6
    for k in ("policy_loss", "value_loss", "entropy", "reward_mean"):
        assert torch.isfinite(torch.tensor(m[k])), k
    assert max(float((p.detach() - q).abs().max()) for p, q in
               zip(state.policy.parameters(), before)) > 0


# ---------------------------------------------------------------------------
# bf16 mode (precision="bf16"), held as chip_smoke.py holds it: features and
# gradients within the float32 rule but for counted bf16 rounding flips, each
# within one bf16 ulp (chip_smoke.flip_check)
# ---------------------------------------------------------------------------

#: (frames, beams, batch): the mini world's rollout (2 arenas x 4 robots)
#: and minibatch, stage 1's rollout, acting and minibatch at 32 arenas, and
#: stage 2's rollout and minibatch at 16 arenas.
BF16_SHAPES = [(3, 64, 8), (3, 64, 256), (3, 512, 768), (3, 512, 3072),
               (3, 512, 32768), (3, 512, 704), (3, 512, 8192)]


def _bf16_inputs(cuda, frames, beams, batch, scans_dtype, seed=0):
    torch.manual_seed(seed)
    policy = CNNPolicy(frames=frames, beams=beams).to(cuda)
    scans = (torch.rand(batch, frames, beams, device=cuda) - 0.5).to(
        scans_dtype)
    act = [w.detach() for w in policy.trunk_weights("act")]
    crt = [w.detach() for w in policy.trunk_weights("crt")]
    return scans, act, crt


@pytest.mark.parametrize("scans_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frames,beams,batch", BF16_SHAPES)
def test_trunk_bf16_kernel_matches_plain(cuda, frames, beams, batch,
                                         scans_dtype):
    import chip_smoke

    scans, act, crt = _bf16_inputs(cuda, frames, beams, batch, scans_dtype)
    with torch.no_grad():
        before = trunk_cuda.launches_by_mode["twin_trunks", batch, "bf16"]
        got = trunk_cuda.twin_trunks(scans, act, crt, "bf16")
        assert trunk_cuda.launches_by_mode[
            "twin_trunks", batch, "bf16"] == before + 1
        want = trunk_cuda.twin_trunks_plain(scans, act, crt, "bf16")
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    chip_smoke.check_features(got, want, "bf16", f"B = {batch}")


@pytest.mark.parametrize("batch", [37, 768, 3072])
def test_trunk_f32_kernel_on_bf16_scans(cuda, batch):
    """The float32 mode on bf16 scans (--obs-bf16 without --bf16): the
    float32 tolerance against the plain version on the same scans."""
    scans, act, crt = _bf16_inputs(cuda, 3, 512, batch, torch.bfloat16)
    with torch.no_grad():
        got = trunk_cuda.twin_trunks(scans, act, crt)
        want = trunk_cuda.twin_trunks_plain(scans, act, crt)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=TRUNK_TOL, rtol=TRUNK_TOL)


@pytest.mark.parametrize("precision", ["float32", "bf16"])
@pytest.mark.parametrize("frames,beams,batch", [(3, 64, 256), (3, 512, 37),
                                                (3, 512, 8192),
                                                (3, 512, 32768)])
def test_trunk_bwd_kernel_bf16_scans_within_rounding_limit(
        cuda, frames, beams, batch, precision):
    """Both modes on bf16 scans (bf16 mode: bf16 cotangent) against the
    plain version in float64, by chip_smoke.check_grads."""
    import chip_smoke

    scans, act, crt = _bf16_inputs(cuda, frames, beams, batch,
                                   torch.bfloat16, seed=1)
    g = torch.randn(2, batch, 256, device=cuda).to(
        trunk_cuda.PRECISIONS[precision])
    before = trunk_cuda.launches_by_mode["twin_trunks_grads", batch,
                                         precision]
    got = trunk_cuda.twin_trunks_grads(scans, act, crt, g, precision)
    assert trunk_cuda.launches_by_mode[
        "twin_trunks_grads", batch, precision] == before + 1
    f64 = lambda ws: [w.double() for w in ws]
    want = trunk_cuda.twin_trunks_grads_plain(scans.double(), f64(act),
                                              f64(crt), g.double(), precision)
    limits = chip_smoke.trunk_grads_limits(scans, act, crt, g, precision)
    torch.cuda.synchronize()
    chip_smoke.check_grads([*got[0], *got[1]], [*want[0], *want[1]], limits,
                           precision, f"B = {batch}")


@pytest.mark.parametrize("batch", [768, 8192])
def test_trunk_bf16_kernels_are_deterministic(cuda, batch):
    """bf16 mode, bf16 scans and cotangent: two launches of each kernel
    agree bit for bit."""
    scans, act, crt = _bf16_inputs(cuda, 3, 512, batch, torch.bfloat16)
    g = torch.randn(2, batch, 256, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        first = trunk_cuda.twin_trunks(scans, act, crt, "bf16")
        second = trunk_cuda.twin_trunks(scans, act, crt, "bf16")
    assert torch.equal(first, second)
    a = trunk_cuda.twin_trunks_grads(scans, act, crt, g, "bf16")
    b = trunk_cuda.twin_trunks_grads(scans, act, crt, g, "bf16")
    assert all(torch.equal(x, y) for x, y in zip((*a[0], *a[1]),
                                                  (*b[0], *b[1])))


def test_trunk_bf16_kernels_refuse_other_dtypes(cuda):
    """No silent cast: float64 scans, bf16 weights or a cotangent of the
    other mode's dtype raise."""
    scans, act, crt = _bf16_inputs(cuda, 3, 512, 8, torch.float32)
    with torch.no_grad(), pytest.raises(ValueError, match="float32 or bf16"):
        trunk_cuda.twin_trunks(scans.double(), act, crt, "bf16")
    with torch.no_grad(), pytest.raises(ValueError, match="weights"):
        trunk_cuda.twin_trunks(scans, [w.bfloat16() for w in act],
                               [w.bfloat16() for w in crt], "bf16")
    with pytest.raises(ValueError, match="cotangent"):
        trunk_cuda.twin_trunks_grads(scans, act, crt,
                                     torch.zeros(2, 8, 256, device=cuda),
                                     "bf16")
    with pytest.raises(ValueError, match="cotangent"):
        trunk_cuda.twin_trunks_grads(
            scans, act, crt,
            torch.zeros(2, 8, 256, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="precision"):
        trunk_cuda.twin_trunks(scans, act, crt, "fp16")


def test_bf16_training_update_on_the_card(cuda):
    """One stage-1 update in bf16 (policy and scans, 2 arenas, horizon 16)
    through all three kernels, the trunks in bf16 mode; finite losses and
    a bf16 rollout buffer."""
    tr = Trainer(TrainConfig.stage1(n_arenas=2, horizon=16,
                                    ppo=PPOConfig(batch_size=256),
                                    policy_dtype=torch.bfloat16,
                                    obs_store_dtype=torch.bfloat16),
                 device=cuda)
    state = tr.init_state()
    assert state.env_state.scan_hist.dtype == torch.bfloat16
    before = dict(trunk_cuda.launches_by_mode)
    replays = graphs.replays
    state, m = tr.train_step(state)
    after = trunk_cuda.launches_by_mode
    # the acting step's warm-up runs before its capture, its 16 replays
    # and the bootstrap
    assert after["twin_trunks", 48, "bf16"] - before.get(
        ("twin_trunks", 48, "bf16"), 0) == graphs.WARMUP + 16 + 1
    assert graphs.replays - replays == 16
    assert after["twin_trunks_grads", 256, "bf16"] - before.get(
        ("twin_trunks_grads", 256, "bf16"), 0) == 6
    for k in ("policy_loss", "value_loss", "entropy", "reward_mean"):
        assert torch.isfinite(torch.tensor(m[k])), k
    assert all(p.dtype == torch.float32 for p in state.policy.parameters())


# ---------------------------------------------------------------------------
# The bf16 mode on the tensor cores (csrc/trunk_mma.cuh, trunk_conv_mma.cuh,
# conv_bwd_mma_kernel): ragged batches against the 128-row tiles, beam counts
# whose conv2 channels split or share the 128-column N tiles (64: L2 = 16;
# 720: L2 = 180), conv1's one or two k16 steps (1 and 3 frames: 5 and 15
# taps; 6 frames: 30), and the bf16 fine-tune's rollout and minibatch (800:
# fc1's K split in 9; 10,240: split in 3, 80 M tiles of db2)
# ---------------------------------------------------------------------------

#: (frames, beams, batch)
TENSOR_CORE_SHAPES = [(3, 512, 33), (3, 512, 768), (3, 512, 1000),
                      (3, 512, 3072), (3, 512, 32768), (3, 512, 800),
                      (3, 512, 10240), (1, 64, 33),
                      (6, 64, 1000), (1, 720, 768), (6, 720, 1000),
                      (3, 720, 3072), (6, 512, 32768)]


@pytest.mark.parametrize("scans_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frames,beams,batch", TENSOR_CORE_SHAPES)
def test_trunk_tensor_core_kernels_match_plain(cuda, frames, beams, batch,
                                               scans_dtype):
    """The bf16 forward and backward against the plain bf16 version, held
    as chip_smoke.py holds them (check_features, check_grads against the
    float64 plain version)."""
    import chip_smoke

    scans, act, crt = _bf16_inputs(cuda, frames, beams, batch, scans_dtype,
                                   seed=frames + beams + batch)
    g = torch.randn(2, batch, 256, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        got = trunk_cuda.twin_trunks(scans, act, crt, "bf16")
        want = trunk_cuda.twin_trunks_plain(scans, act, crt, "bf16")
    torch.cuda.synchronize()
    chip_smoke.check_features(got, want, "bf16", f"B = {batch}")
    grads = trunk_cuda.twin_trunks_grads(scans, act, crt, g, "bf16")
    f64 = lambda ws: [w.double() for w in ws]
    ref = trunk_cuda.twin_trunks_grads_plain(scans.double(), f64(act),
                                             f64(crt), g.double(), "bf16")
    limits = chip_smoke.trunk_grads_limits(scans, act, crt, g, "bf16")
    torch.cuda.synchronize()
    chip_smoke.check_grads([*grads[0], *grads[1]], [*ref[0], *ref[1]],
                           limits, "bf16", f"B = {batch}")


@pytest.mark.parametrize("frames,beams,batch", [(6, 720, 1000),
                                                (3, 512, 32768)])
def test_trunk_tensor_core_kernels_are_deterministic(cuda, frames, beams,
                                                     batch):
    """No float atomics in any bf16 pass: two launches bit-equal."""
    scans, act, crt = _bf16_inputs(cuda, frames, beams, batch, torch.float32)
    g = torch.randn(2, batch, 256, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        first = trunk_cuda.twin_trunks(scans, act, crt, "bf16")
        second = trunk_cuda.twin_trunks(scans, act, crt, "bf16")
    assert torch.equal(first, second)
    a = trunk_cuda.twin_trunks_grads(scans, act, crt, g, "bf16")
    b = trunk_cuda.twin_trunks_grads(scans, act, crt, g, "bf16")
    assert all(torch.equal(x, y) for x, y in zip((*a[0], *a[1]),
                                                  (*b[0], *b[1])))


def test_trunk_kernels_use_tensor_cores_in_bf16_mode_only(cuda):
    """cuobjdump -sass of the built library: HMMA/HGMMA in every bf16
    product, conv-pass and conv_bwd kernel, none in a float32 kernel."""
    import chip_smoke

    counts = chip_smoke.check_sass()
    assert all(min(counts[n]) > 0 for n in chip_smoke.TENSOR_CORE_KERNELS)
    assert all(max(counts[n]) == 0 for n in chip_smoke.FLOAT32_KERNELS)


def test_trunk_float32_mode_unmoved_by_bf16_launches(cuda):
    """The two modes share no mutable state: float32 features and gradients
    bit-equal before and after bf16 launches on the same weights."""
    scans, act, crt, g = _bwd_inputs(cuda, 1000, seed=4)

    def f32():
        with torch.no_grad():
            feats = trunk_cuda.twin_trunks(scans, act, crt)
        return [feats, *(x for pair in trunk_cuda.twin_trunks_grads(
            scans, act, crt, g) for x in pair)]

    before = f32()
    with torch.no_grad():
        trunk_cuda.twin_trunks(scans.bfloat16(), act, crt, "bf16")
    trunk_cuda.twin_trunks_grads(scans, act, crt, g.bfloat16(), "bf16")
    after = f32()
    assert all(torch.equal(x, y) for x, y in zip(before, after))


def test_results_pipeline_selection_on_the_card(cuda, tmp_path,
                                                monkeypatch):
    """examples/make_results.py's fine-tune with circle selection on the
    card at a tiny depth (one arena, horizon 8, two chunks of one update,
    20-step selection evals): the kept params are those of the chunk that
    select_score ranks first (the earlier on a tie), and the files and the
    phase record are written."""
    import csv

    from rl_collision_avoidance_torch.examples import make_results
    from rl_collision_avoidance_torch.utils.params import (
        jax_params_to_torch, load_jax_npz)

    params = make_results.RESULTS / "circle_ft_params.npz"
    ppo = TrainConfig.circle_ft().ppo._replace(batch_size=80)
    real, seen = make_results.run_circle_eval, []

    def recording(policy, **kw):
        seen.append({k: v.detach().cpu().clone()
                     for k, v in policy.state_dict().items()})
        return real(policy, **kw)

    monkeypatch.setattr(make_results, "run_circle_eval", recording)
    before = trunk_cuda.bwd_launches
    record = make_results.train("circle_ft", 2, 1, str(tmp_path),
                                warm_start=str(params), circle_select_every=1,
                                device=cuda, select_steps=20, horizon=8,
                                ppo=ppo)
    assert trunk_cuda.bwd_launches - before == 2 * 5 * 4
    with open(tmp_path / "circle_ft_circle_curve.csv") as f:
        curve = [{k: float(v) for k, v in r.items()}
                 for r in csv.DictReader(f)]
    assert [r["update"] for r in curve] == [1.0, 2.0]
    scores = [make_results.select_score(
        {"success_rate_mean": r["circle_success_mean"],
         "collisions_mean": r["collisions_mean"]}) for r in curve]
    assert record["circle_select_best_score"] == round(max(scores), 4)
    kept = jax_params_to_torch(load_jax_npz(tmp_path / "circle_ft_params.npz"))
    first_best = seen[scores.index(max(scores))]
    assert all(torch.equal(kept[k], v) for k, v in first_best.items())
    assert all(torch.isfinite(v).all() for v in kept.values())
    assert (tmp_path / "circle_ft_metrics.csv").is_file()


# ---------------------------------------------------------------------------
# The acting step's CUDA graphs (utils/graphs.py): the graphed step against
# the same step callable run eagerly (graphs.captured_on patched to False)
# ---------------------------------------------------------------------------

TRAIN_PRESETS = {"stage1": TrainConfig.stage1, "stage2": TrainConfig.stage2}
GRAPH_HORIZON = 16


def _small_trainer(cuda, world, dtype=torch.float32):
    """2 arenas of ``world`` at GRAPH_HORIZON steps, 4 minibatches x 2
    epochs; bf16 policy and scans with ``dtype`` bf16."""
    n = get_world(world).n_robots
    bf16 = dtype == torch.bfloat16
    cfg = TRAIN_PRESETS[world](
        n_arenas=2, horizon=GRAPH_HORIZON,
        ppo=PPOConfig(batch_size=2 * n * GRAPH_HORIZON // 4, epochs=2),
        policy_dtype=dtype, obs_store_dtype=dtype if bf16 else None)
    return Trainer(cfg, device=cuda)


def _three_updates(cuda, world, dtype, inject):
    """Three updates from a fresh trainer, with the PPO update between the
    rollouts; ``inject``: the action noise and reset samples given (drawn
    from a seeded generator and the env's sampler).  Returns each update's
    metrics, parameters and env state, the rise of the graph counts and of
    the forward kernel's launches, and a last rollout's trajectory and
    bootstrap value."""
    tr = _small_trainer(cuda, world, dtype)
    state = tr.init_state()
    gen = torch.Generator(device=cuda).manual_seed(11)
    e = 2 * tr.spec.n_robots
    counts = (graphs.captures, graphs.replays, trunk_cuda.launches)
    out = []
    for _ in range(3):
        draws = () if not inject else (
            torch.randn((GRAPH_HORIZON, e, 2), generator=gen, device=cuda),
            [tr.env.sample_pose_goal(2) for _ in range(GRAPH_HORIZON)])
        state, m = tr.train_step(state, *draws)
        out += [m, *(v.clone() for v in state.policy.state_dict().values()),
                *(x.clone() for x in vars(state.env_state).values())]
    rises = (graphs.captures - counts[0], graphs.replays - counts[1],
             trunk_cuda.launches - counts[2])
    _, traj, value = tr._rollout(state)
    out += [*(traj[k].clone() for k in sorted(traj)), value]
    return out, rises


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


@pytest.mark.parametrize("world,dtype,inject", [
    ("stage1", torch.float32, True), ("stage1", torch.float32, False),
    ("stage2", torch.float32, True), ("stage2", torch.float32, False),
    ("stage1", torch.bfloat16, False), ("stage2", torch.bfloat16, True)])
def test_graphed_updates_are_the_eager_updates(cuda, monkeypatch, world,
                                               dtype, inject):
    """Three stage-1 or stage-2 updates with the acting step replayed from
    its graph are the updates with the step run eagerly, bit for bit: every
    metric, parameter and env tensor after each update (so each replay read
    the parameters the PPO update wrote in place), and a fourth rollout;
    in float32 and bf16, on injected draws and on the generators'.  One
    capture, then one replay a step, which counts the forward it launches:
    the kernel's launches are the eager updates' and the capture's warm-up
    runs."""
    graphed, rises = _three_updates(cuda, world, dtype, inject)
    assert rises[:2] == (1, 3 * GRAPH_HORIZON)
    monkeypatch.setattr(graphs, "captured_on", lambda device: False)
    eager, eager_rises = _three_updates(cuda, world, dtype, inject)
    assert eager_rises[:2] == (0, 0)
    assert rises[2] == eager_rises[2] + graphs.WARMUP
    assert _same(graphed, eager)


def _circle_eval_setup(cuda, arenas):
    from rl_collision_avoidance_torch.eval import circle as circle_eval
    from rl_collision_avoidance_torch.models import load_policy

    policy = load_policy(RESULTS / "circle_ft_params.npz", device=cuda)
    env = Env(circle(), device=cuda, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(3)
    noise = circle_eval.pose_noise_draw(arenas, env.n_robots, 0.1, gen)
    return circle_eval, policy, env, noise


def _stepped(env, actions):
    """``env.step`` recording a copy of each action it is handed."""
    env_step = env.step

    def step(state, action, *args, **kwargs):
        actions.append(action.clone())
        return env_step(state, action, *args, **kwargs)
    return step


def test_graphed_eval_is_the_eager_eval(cuda, monkeypatch):
    """run_episodes on the circle, 4 arenas at 0.1 m of jitter, until the
    eval_check ends it: every action handed to Env.step and each robot's
    first result and its step are the eager step's, bit for bit."""
    circle_eval, policy, env, noise = _circle_eval_setup(cuda, 4)
    runs = []
    for graphed in (True, False):
        if not graphed:
            monkeypatch.setattr(graphs, "captured_on", lambda device: False)
        actions = []
        monkeypatch.setattr(env, "step", _stepped(env, actions))
        done, first, start = circle_eval.run_episodes(policy, env, 4, 3000,
                                                      noise)
        monkeypatch.undo()
        runs.append([done, first, start, *actions])
    assert bool((runs[0][1] != 0).all())         # every robot has a result
    assert len(runs[0]) - 3 < 3000               # so the check ended it
    assert _same(*runs)


def test_a_new_eval_shape_captures_and_the_same_replays(cuda):
    """run_episodes again at the same arena count replays the kept graphs;
    at a second arena count it captures the policy's and the
    bookkeeping's graphs once each; every call replays both a step."""
    circle_eval, policy, env, noise = _circle_eval_setup(cuda, 5)
    steps = 20
    rises = []
    for arenas in (3, 3, 5):
        before = (graphs.captures, graphs.replays)
        circle_eval.run_episodes(policy, env, arenas, steps, noise[:arenas])
        rises.append((graphs.captures - before[0],
                      graphs.replays - before[1]))
    assert rises[1:] == [(0, 2 * steps), (2, 2 * steps)]
    assert rises[0][1] == 2 * steps


def test_kept_eval_graphs_go_with_their_policy(cuda):
    """The eval's kept graphs hold no reference to their policy: once the
    caller drops the policy, they go with it."""
    circle_eval, policy, env, noise = _circle_eval_setup(cuda, 2)
    circle_eval.run_episodes(policy, env, 2, 5, noise)
    assert policy in circle_eval._KEPT
    kept, gone = len(circle_eval._KEPT), weakref.ref(policy)
    del policy
    gc.collect()
    assert gone() is None and len(circle_eval._KEPT) < kept


def test_checkpoint_round_trip_across_graphed_updates(cuda, tmp_path):
    """A stage-1 update with the graphed acting step, a save, two more
    updates; the save restored into the same trainer (a new policy: a new
    graph key, captured once) gives the same two updates bit for bit."""
    from rl_collision_avoidance_torch.utils.checkpoint import (
        CheckpointManager)

    tr = _small_trainer(cuda, "stage1")
    state, _ = tr.train_step(tr.init_state())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.update, tr.state_dict(state))
    runs = []
    for _ in range(2):
        captures = graphs.captures
        out = []
        for _ in range(2):
            state, m = tr.train_step(state)
            out += [m, *(v.clone() for v in
                         state.policy.state_dict().values()),
                    *(x.clone() for x in vars(state.env_state).values())]
        runs.append((out, graphs.captures - captures))
        state = tr.load_state_dict(mgr.restore(1, tr.device))
    (ahead, none), (again, one) = runs
    assert (none, one) == (0, 1)
    assert _same(ahead, again)


# ---------------------------------------------------------------------------
# multi-process training (parallel/dist.py, algo/ppo.py::ppo_update)
# ---------------------------------------------------------------------------


def test_one_rank_nccl_update_is_the_one_process_update(cuda, tmp_path):
    """A one-rank NCCL group, whose all-reduces really run: ppo_update at
    stage-1 widths and a minibatch of B = 768 (2 minibatches x 2 epochs,
    through the trunk kernels) is the update without a group bit for
    bit."""
    from rl_collision_avoidance_torch.algo.ppo import Batch, ppo_update
    from rl_collision_avoidance_torch.parallel import (setup_distributed,
                                                       teardown, world_size)

    m, g = 1536, torch.Generator(device=cuda).manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g, device=cuda)
    batch = Batch(scans=torch.rand((m, 3, 512), generator=g, device=cuda)
                  - 0.5, goal=r(m, 2), speed=r(m, 2), action=r(m, 2),
                  logprob=r(m, 1), target=r(m, 1), adv=r(m, 1),
                  weight=(torch.rand(m, generator=g, device=cuda)
                          > 0.2).float())
    cfg = PPOConfig(batch_size=768, epochs=2)
    perms = torch.stack([torch.randperm(m, generator=g, device=cuda)
                         for _ in range(2)])
    torch.manual_seed(1)
    start = CNNPolicy().to(cuda).state_dict()

    def run():
        policy = CNNPolicy().to(cuda)
        policy.load_state_dict(start)
        opt = torch.optim.Adam(policy.parameters(), lr=5e-5)
        launches = trunk_cuda.bwd_launches
        out = ppo_update(policy, opt, batch, cfg, perms)
        assert trunk_cuda.bwd_launches - launches == 4
        return policy.state_dict(), out["minibatches"]

    a, ma = run()
    setup_distributed(f"file://{tmp_path}/store", 1, 0)
    try:
        assert world_size() == 1
        b, mb = run()
    finally:
        teardown()
    assert all(torch.equal(v, b[k]) for k, v in a.items())
    assert torch.equal(ma, mb)


def test_nccl_refuses_two_ranks_on_one_card(cuda, tmp_path):
    """Two NCCL ranks that map to one card (one card visible): each rank's
    setup raises the error that says so, and neither hangs."""
    from torch_dist_worker import run_ranks

    outs = run_ranks("nccl_twice", {}, tmp_path,
                     env={"CUDA_VISIBLE_DEVICES": "0"}, timeout=300)
    for out in outs:
        assert out["error"] and "NCCL takes one rank a device" in out["error"]
