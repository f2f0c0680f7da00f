"""The port's CUDA kernels and paths against their plain PyTorch versions,
on the card.

Each kernel is held at every world, batch and precision a path of the port
gives it (``PATHS``), and each path of the curriculum runs on the card at
its presets' widths, cut in depth, by the gates of ``tests/card_gates.py``.
Marked ``gpu``; every test skips where no CUDA card is visible.  This file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import copy
import csv
import dataclasses
import gc
import inspect
import json
import math
import shutil
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from card_gates import (BF16_ULP, EVAL_MIN_SUCCESS, GRAD_ATOL, GRAD_NORM,
                        LIDAR_ATOL, MLP_ATOL, MP_MIN_GOAL, POLICY_ATOL,
                        RECT_MIN_SUCCESS, RECT_RING, S1_MIN_GOAL, S2_MIN_GOAL,
                        check_features, check_grads, check_sass,
                        compare_minibatch_grads, env_launches, flip_check,
                        read_counts, read_sass, reset_counts,
                        sass_mma_counts, training_launches,
                        trunk_grads_limits)
from rl_collision_avoidance_torch import bench
from rl_collision_avoidance_torch.algo import PPOConfig
from rl_collision_avoidance_torch.engine.env import Env, EnvState
from rl_collision_avoidance_torch.examples import (make_results,
                                                   train_curriculum)
from rl_collision_avoidance_torch.models import (CNNPolicy, MLPPolicy,
                                                 load_policy)
from rl_collision_avoidance_torch.ops import env_cuda, lidar_cuda, trunk_cuda
from rl_collision_avoidance_torch.train import TrainConfig, Trainer
from rl_collision_avoidance_torch.utils import graphs
from rl_collision_avoidance_torch.utils.params import (jax_params_to_torch,
                                                       load_jax_npz)
from rl_collision_avoidance_torch.worlds import (circle, compile_world,
                                                 get_world, mini, stage1,
                                                 stage2)
from torch_dist_worker import run_ranks

pytestmark = pytest.mark.gpu

RESULTS = Path(__file__).resolve().parents[1] / "results"
PARAMS = RESULTS / "stage1_params.npz"
CIRCLE_PARAMS = RESULTS / "circle_ft_params.npz"
SEED = 0
# Arenas of the paths, as their presets and entry points set them.
ACT_ARENAS = inspect.signature(bench.measure).parameters["arenas"].default
TRAIN_ARENAS = make_results.ARENAS["stage1"]
S2_ARENAS = make_results.ARENAS["stage2"]
FT_ARENAS = make_results.ARENAS["circle_ft"]
EVAL_ARENAS = make_results.EVAL_ARENAS
SELECT_ARENAS = make_results.SELECT_ARENAS
CURRICULUM_ARENAS = inspect.signature(
    train_curriculum.curriculum).parameters["n_arenas"].default
RANKS = 2             # gloo ranks sharing the card
# The box footprint's committed evals (results/circle_eval_rect.json): the
# ring, the ring culled to the RECT_CULL_K nearest, RECT_ARENAS at 0.3 m.
RECT_CULL_K = 12
RECT_NOISE = 0.3
RECT_ARENAS = json.loads((RESULTS / "circle_eval_rect.json").read_text())[
    "rect_jitter_0.3m"]["n_arenas"]
S1_BATCH = TrainConfig.stage1(n_arenas=TRAIN_ARENAS).ppo.batch_size
S2_BATCH = TrainConfig.stage2(n_arenas=S2_ARENAS).ppo.batch_size
FT_BATCH = TrainConfig.circle_ft(n_arenas=FT_ARENAS).ppo.batch_size
#: The weights each world's checks and paths use: stage 2 warm-starts from
#: stage 1, the circle eval and the fine-tune use the fine-tuned policy.
WORLD_PARAMS = {"stage1": PARAMS, "stage2": PARAMS, "stage1_rect": PARAMS,
                "circle": CIRCLE_PARAMS, "circle_train": CIRCLE_PARAMS,
                "circle_12": CIRCLE_PARAMS, "circle_rect": CIRCLE_PARAMS}
#: (precision, scans dtype) modes of a path: float32; bf16 on bf16 scans
#: (--bf16 --obs-bf16); the fine-tune's bf16 also on float32 scans (--bf16
#: alone, make_results' circle_ft_bf16_f32obs).
F32 = (("float32", torch.float32),)
BOTH = F32 + (("bf16", torch.bfloat16),)
FT_MODES = BOTH + (("bf16", torch.float32),)
#: The port's paths on the card: (world, arenas, PPO minibatch or None,
#: modes).  Each gives the lidar kernel (walls-only on the box footprint),
#: the env-step kernels (disc worlds) and the trunk forward its arenas'
#: robots; a training path gives the forward and the backward its minibatch.
PATHS = [("stage1", ACT_ARENAS, None, BOTH),       # the acting slice
         ("stage1", TRAIN_ARENAS, S1_BATCH, BOTH),
         ("stage1", TRAIN_ARENAS // RANKS, S1_BATCH // RANKS, BOTH),  # a rank
         ("stage1_rect", TRAIN_ARENAS, S1_BATCH, F32),
         ("stage2", S2_ARENAS, S2_BATCH, BOTH),
         ("circle_train", FT_ARENAS, FT_BATCH, FT_MODES),
         ("circle", 1, None, F32),                  # the ring
         ("circle", EVAL_ARENAS, None, F32),
         ("circle", SELECT_ARENAS, None, F32),      # the fine-tune's selection
         ("circle", CURRICULUM_ARENAS[2], None, F32),
         ("circle_12", 1, None, F32),               # the sweep's 12-robot ring
         ("circle_rect", 1, None, F32),
         ("circle_rect", RECT_ARENAS, None, F32)]
RECT_WORLDS = ("stage1_rect", "circle_rect")


def _spec(world: str):
    """The WorldSpec of a world of PATHS: ``circle_12`` is the circle with 12
    robots on its 25 m ring, ``circle_rect`` the circle with the box
    footprint, any other ``get_world``'s."""
    if world == "circle_12":
        return circle(n_robots=12)
    if world == "circle_rect":
        return dataclasses.replace(circle(), footprint="rect")
    return get_world(world)


N_ROBOTS = {w: _spec(w).n_robots for w in dict.fromkeys(p[0] for p in PATHS)}
#: (world, arenas) of the disc paths (lidar_obs, the env-step kernels) and of
#: the box footprint's (lidar_obs_walls).
DISC_PATHS = list(dict.fromkeys((w, a) for w, a, _, _ in PATHS
                                if w not in RECT_WORLDS))
WALLS_PATHS = list(dict.fromkeys((w, a) for w, a, _, _ in PATHS
                                 if w in RECT_WORLDS))
#: (world, batch, precision, scans dtype) of the trunk forward and backward.
FWD_PATHS = list(dict.fromkeys(
    (w, b, p, d) for w, a, mb, modes in PATHS for p, d in modes
    for b in (a * N_ROBOTS[w], mb) if b))
BWD_PATHS = list(dict.fromkeys((w, mb, p, d) for w, _, mb, modes in PATHS
                               if mb for p, d in modes))
#: Every (kernel, batch, precision) held above: a path launches no other.
CHECKED = ({(k, a * N_ROBOTS[w], "float32") for w, a in DISC_PATHS
            for k in ("lidar_obs", "env_physics", "env_sample", "env_reset")}
           | {("lidar_obs_walls", a * N_ROBOTS[w], "float32")
              for w, a in WALLS_PATHS}
           | {("twin_trunks", b, p) for _, b, p, _ in FWD_PATHS}
           | {("twin_trunks_grads", b, p) for _, b, p, _ in BWD_PATHS})


def _ids(value):
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    if isinstance(value, tuple):      # a random source: frames, beams, seed
        return "random-{}x{}-{}".format(*value)
    return None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _lidar_args(env):
    t = env.lidar_table
    return (env._lidar_cells, t.lo, t.cell, t.shape, env.local_dirs,
            env.spec.robot_radius, env.spec.max_range)


def _test_poses(env, arenas: int):
    """Seeded poses of ``arenas`` arenas: the world's reset poses, in stage
    1 with one robot 0.3-0.5 m from the east wall facing it and a pair
    0.5-0.7 m apart an arena, in the circle worlds' further arenas drawn in
    towards the centre down to 4 m with random headings; with more than one
    arena of at least 24 robots, the last one the culling rules' edge cases
    (lidar_cuda.adversarial_poses)."""
    spec, g, dev = env.spec, env.generator, env.device
    pose = env.sample_pose_goal(arenas)[0]
    if spec.name.startswith("stage1"):
        u = torch.rand((arenas, 4), generator=g, device=dev)
        pose[:, 0, 0] = 9.6 - 0.3 - 0.2 * u[:, 0]          # wall at x = 9.6
        pose[:, 0, 1] = 2.0 * u[:, 1] - 1.0
        pose[:, 0, 2] = 0.5 * u[:, 2] - 0.25
        gap, ang = 0.5 + 0.2 * u[:, 3], 2 * math.pi * u[:, 2]
        pose[:, 2, 0] = pose[:, 1, 0] + gap * torch.cos(ang)
        pose[:, 2, 1] = pose[:, 1, 1] + gap * torch.sin(ang)
    if spec.name.startswith("circle") and arenas > 1:
        scale = torch.linspace(1.0, 0.16, arenas, device=dev)
        pose[..., :2] *= scale[:, None, None]
        pose[1:, :, 2] = 2 * math.pi * torch.rand(pose[1:, :, 2].shape,
                                                  generator=g, device=dev)
    if arenas > 1 and spec.n_robots >= 24:
        pose[-1] = torch.from_numpy(lidar_cuda.adversarial_poses(
            spec, spec.n_robots, seed=SEED))[0].to(dev)
    return pose.contiguous()


@pytest.mark.parametrize("world,arenas", list(dict.fromkeys([
    ("stage1", 16), ("mini", 5), ("stage2", 16), ("circle", 1),
    ("circle", 32), ("circle_train", 16), *DISC_PATHS])))
def test_lidar_kernel_matches_plain(cuda, world, arenas):
    """At each world and arena count of the disc paths (and mini's 64
    beams), on the world's test poses: one launch counted at its batch,
    finite and within LIDAR_ATOL of the plain version."""
    env = Env(_spec(world), device=cuda, seed=3)
    pose = _test_poses(env, arenas)
    key = ("lidar_obs", arenas * env.n_robots, "float32")
    before = lidar_cuda.launches_by_mode[key]
    got = lidar_cuda.lidar_obs(pose, *_lidar_args(env))
    assert lidar_cuda.launches_by_mode[key] == before + 1
    want = lidar_cuda.lidar_obs_plain(pose, *_lidar_args(env))
    torch.cuda.synchronize()
    assert got.shape == (arenas, env.n_robots, env.spec.n_beams)
    assert bool(torch.isfinite(got).all())
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


@pytest.mark.parametrize("world,arenas", WALLS_PATHS)
def test_lidar_walls_only_kernel_matches_plain(cuda, world, arenas):
    """The walls-only mode (discs=False) at the box footprint's paths
    against lidar_obs_plain(discs=False) on the world's test poses with an
    adversarial_poses arena last: within LIDAR_ATOL, bit-equal over two
    launches, counted as walls-only."""
    env = Env(_spec(world), device=cuda, seed=5)
    s = env.spec
    pose = _test_poses(env, arenas)
    pose[-1] = torch.from_numpy(lidar_cuda.adversarial_poses(
        s, s.n_robots, seed=arenas))[0].to(cuda)
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


@pytest.mark.parametrize("world,kw", [
    ("stage1_rect", {}), ("circle_rect", {}),
    ("circle_rect", {"disc_cull_k": RECT_CULL_K})])
def test_rect_env_kernel_path_matches_plain_path(cuda, world, kw):
    """Five steps of the box footprint through the walls-only kernel and
    the plain path on the card, from the same state, actions and reset
    draws: poses, rewards and flags equal, scans within LIDAR_ATOL."""
    env = Env(_spec(world), device=cuda, seed=0, **kw)
    plain = Env(_spec(world), device=cuda, use_kernels=False, **kw)
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


def _inputs(cuda, source, batch, scans_dtype=torch.float32,
            precision="float32", steps=0):
    """``batch`` scans in ``scans_dtype``, the two trunks' weights and a
    cotangent in ``precision``.  ``source`` a world of PATHS: its trained
    policy's weights and the world's scans at its reset (three equal
    frames) or after ``steps`` acting steps of that policy.  ``source``
    (frames, beams, seed): random weights and scans from that seed."""
    if isinstance(source, str):
        spec = _spec(source)
        policy = load_policy(WORLD_PARAMS[source], device=cuda)
        env = Env(spec, device=cuda, seed=SEED + 1 + (steps > 0),
                  obs_dtype=scans_dtype)
        state, obs = env.reset(-(-batch // spec.n_robots))
        gen = torch.Generator(device=cuda).manual_seed(SEED + 2)
        if steps:
            _, obs, _ = bench.run_acting(env, policy, state, obs, steps, gen)
        scans = obs.scans.reshape(-1, spec.laser_frames,
                                  spec.n_beams)[:batch].contiguous()
        g = torch.randn((2, batch, 256), generator=gen, device=cuda)
    else:
        frames, beams, seed = source
        torch.manual_seed(seed)
        policy = CNNPolicy(frames=frames, beams=beams).to(cuda)
        scans = (torch.rand(batch, frames, beams, device=cuda) - 0.5).to(
            scans_dtype)
        g = torch.randn(2, batch, 256, device=cuda)
    return (scans, *([w.detach() for w in policy.trunk_weights(t)]
                     for t in ("act", "crt")),
            g.to(trunk_cuda.PRECISIONS[precision]))


def _launch(fn, key):
    """``fn()``, a trunk wrapper's launch at ``key`` (kernel, batch,
    precision), twice: it is counted once a call, the two are bit-equal (no
    float atomics), and the rise of the caching allocator's peak over the
    first holds the workspace it allocated."""
    before = trunk_cuda.launches_by_mode[key]
    trunk_cuda.workspace_bytes.pop(key, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()    # a fault inside the kernel surfaces here
    assert (torch.cuda.max_memory_allocated() - base
            >= trunk_cuda.workspace_bytes[key])
    flat = lambda o: o if isinstance(o, torch.Tensor) else [*o[0], *o[1]]
    assert all(torch.equal(a, b) for a, b in zip(flat(out), flat(fn())))
    assert trunk_cuda.launches_by_mode[key] == before + 2
    return out


def _random(seed, frames=3, beams=512):
    return (frames, beams, seed)


#: (frames, beams, batch) of random bf16 cases on the tensor cores
#: (csrc/trunk_mma.cuh, trunk_conv_mma.cuh, conv_bwd_mma_kernel): ragged
#: batches against the 128-row tiles, beam counts whose conv2 channels
#: split or share the 128-column N tiles (64: L2 = 16; 720: L2 = 180),
#: conv1's one or two k16 steps (1 and 3 frames: 5 and 15 taps; 6 frames:
#: 30), and the bf16 fine-tune's rollout and minibatch (800: fc1's K split
#: in 9; 10,240: split in 3, 80 M tiles of db2).
TENSOR_CORE_SHAPES = [(3, 512, 33), (3, 512, 768), (3, 512, 1000),
                      (3, 512, 3072), (3, 512, 32768), (3, 512, 800),
                      (3, 512, 10240), (1, 64, 33),
                      (6, 64, 1000), (1, 720, 768), (6, 720, 1000),
                      (3, 720, 3072), (6, 512, 32768)]
#: Random cases of both kernels (source, batch, precision, scans dtype): 1-6
#: frames and beam counts that are multiples of 16 (the mini world has 64
#: beams), and the tensor-core shapes on float32 and bf16 scans.
RANDOM_BOTH = [
    *((_random(f * b, f, b), 45, "float32", torch.float32)
      for f, b in ((3, 64), (1, 16), (6, 128))),
    *((_random(f + b + n, f, b), n, "bf16", d) for f, b, n in
      TENSOR_CORE_SHAPES for d in (torch.float32, torch.bfloat16))]
#: The forward's: float32 at batches ragged against the tiles and the
#: split-K ranges (768: fc1 split; 4,099: not), on bf16 scans (--obs-bf16
#: without --bf16), and bf16 at the mini world's rollout (2 arenas x 4
#: robots) and minibatch, stage 1's and stage 2's shapes.
RANDOM_FWD = list(dict.fromkeys([
    *((_random(n), n, "float32", torch.float32)
      for n in (1, 37, 50, 704, 768, 1000, 3072, 4099, 8192, 10240)),
    *((_random(0), n, "float32", torch.bfloat16) for n in (37, 768, 3072)),
    *((_random(0, f, b), n, "bf16", d)
      for f, b, n in ((3, 64, 8), (3, 64, 256), (3, 512, 768),
                      (3, 512, 3072), (3, 512, 32768), (3, 512, 704),
                      (3, 512, 8192))
      for d in (torch.float32, torch.bfloat16)),
    *RANDOM_BOTH]))
#: The backward's: float32 at batches ragged against the 128-sample tiles,
#: the split-K ranges and the conv blocks, and both modes on bf16 scans.
RANDOM_BWD = [*((_random(0), n, "float32", torch.float32)
                for n in (37, 50, 704, 1000, 4099, 8192, 10240)),
              *((_random(1, f, b), n, p, torch.bfloat16)
                for f, b, n in ((3, 64, 256), (3, 512, 37), (3, 512, 8192),
                                (3, 512, 32768))
                for p in ("float32", "bf16")),
              *RANDOM_BOTH]


@pytest.mark.parametrize("source,batch,precision,scans_dtype",
                         RANDOM_FWD + FWD_PATHS, ids=_ids)
def test_trunk_kernel_matches_plain(cuda, source, batch, precision,
                                    scans_dtype):
    """The forward kernel against its plain version on random weights and
    scans, and at each world, batch and mode of the paths on the world's
    scans with its trained weights: float32 within TRUNK_ATOL + TRUNK_RTOL
    of it, bf16 by the rounding-flip rule (check_features)."""
    scans, act, crt, _ = _inputs(cuda, source, batch, scans_dtype)
    with torch.no_grad():
        got = _launch(lambda: trunk_cuda.twin_trunks(scans, act, crt,
                                                     precision),
                      ("twin_trunks", batch, precision))
        want = trunk_cuda.twin_trunks_plain(scans, act, crt, precision)
    assert got.dtype == trunk_cuda.PRECISIONS[precision]
    check_features(got, want, precision, f"{source} B = {batch}")


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


@pytest.mark.parametrize("batch", [37, 1000])
def test_trunk_bwd_kernel_matches_plain(cuda, batch):
    """Against the plain version in float64; each leaf at 1e-5 of its
    largest value (its batch sums run in another order than cuDNN's)."""
    scans, act, crt, g = _inputs(cuda, _random(0), batch)
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


@pytest.mark.parametrize("source,batch,precision,scans_dtype",
                         RANDOM_BWD + BWD_PATHS, ids=_ids)
def test_trunk_bwd_kernel_within_rounding_limit(cuda, source, batch,
                                                precision, scans_dtype):
    """Against the plain version in float64 on random weights and scans,
    and at each minibatch and mode of the training paths on the world's
    scans after two acting steps with its trained weights: within the
    float32 rounding limit of check_grads (at B = 4,099 an fc1 ReLU that
    float32 turns the other way moves a conv gradient by ~1e-3 of its
    largest value in the kernel and not in cuBLAS), bf16 by its flip rule."""
    scans, act, crt, g = _inputs(cuda, source, batch, scans_dtype, precision,
                                 steps=2)
    got = _launch(lambda: trunk_cuda.twin_trunks_grads(scans, act, crt, g,
                                                       precision),
                  ("twin_trunks_grads", batch, precision))
    f64 = lambda ws: [w.double() for w in ws]
    want = trunk_cuda.twin_trunks_grads_plain(scans.double(), f64(act),
                                              f64(crt), g.double(), precision)
    check_grads([*got[0], *got[1]], [*want[0], *want[1]],
                trunk_grads_limits(scans, act, crt, g, precision), precision,
                f"{source} B = {batch}")


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
#: same draws), and bf16 scans; then every disc path's world and arenas.
ENV_CASES = list(dict.fromkeys([
    ("stage1", 8, True, None), ("stage1", 8, False, None),
    ("stage2", 4, True, None), ("stage2", 4, False, None),
    ("circle", 4, True, None), ("circle_train", 3, True, None),
    ("circle_train", 3, False, None), ("stage1", 4, False, torch.bfloat16),
    *((w, a, True, None) for w, a in DISC_PATHS)]))


@pytest.mark.parametrize("world,arenas,inject,obs_dtype", ENV_CASES,
                         ids=_ids)
def test_env_kernel_path_matches_plain_path(cuda, world, arenas, inject,
                                            obs_dtype):
    """240 chained steps of the kernel path (``ops/env_cuda.py``) and of
    ``use_kernels=False`` on the card from the world's test poses, each
    path on its own states: every bool and int field equal and every float
    field of the env step bit-equal at every step (the scans, from the
    lidar kernel and its plain version, within LIDAR_ATOL, and bf16 scans
    within one bf16 ulp more).  Actions run out of their bounds; every 40
    steps the last arena gets robots on the thresholds (``_on_the_edges``),
    and every 60 steps the first arena times out as a whole, so that stage
    2's and circle_train's groups reset.  The kernel
    path leaves its input state as it was."""
    spec = _spec(world)
    env = Env(spec, device=cuda, seed=0, obs_dtype=obs_dtype)
    plain = Env(spec, device=cuda, seed=0, use_kernels=False,
                obs_dtype=obs_dtype)
    assert env._kernels is not None and plain._kernels is None
    n = env.n_robots
    poser = Env(spec, device=cuda, seed=0)  # leaves the two generators alike
    pose, goal = _test_poses(poser, arenas), poser.sample_pose_goal(arenas)[1]
    state, _ = env.reset(arenas, pose, goal)
    pstate, _ = plain.reset(arenas, pose.clone(), goal.clone())
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
                ulp = BF16_ULP if obs_dtype == torch.bfloat16 else 0.0
                assert bool(((v.float() - w.float()).abs() <= LIDAR_ATOL
                             + ulp * w.float().abs()).all()), k
            else:
                assert torch.equal(v, w), f"step {t}: {k} differs"
        state, pstate = (EnvState(**{k[6:]: v for k, v in out.items()
                                     if k.startswith("state.")})
                         for out in (got, want))
        resets += int((state.step == 0).sum())
    torch.cuda.synchronize()
    fixed = spec.reset_mode.name == "FIXED_TABLES"
    robots = arenas * n
    assert env_cuda.launches_by_mode["env_physics", robots, "float32"] \
        - counts["env_physics", robots, "float32"] == 240
    for k in ("env_sample", "env_reset"):
        assert env_cuda.launches_by_mode[k, robots, "float32"] \
            - counts[k, robots, "float32"] == (0 if fixed else 240), k
    assert fixed or resets > 0


#: The reset sampler's paths: the training worlds at their presets' arenas
#: (stage 1 per robot, stage 2's tables and corridor, circle_train's
#: jittered tables).
SAMPLE_PATHS = [("stage1", TRAIN_ARENAS), ("stage2", S2_ARENAS),
                ("circle_train", FT_ARENAS)]


def _edge_uniforms(env, u_pose, u_goal, u_jitter, cur):
    """The last arena's first robots of ``env``'s world set on the
    samplers' edges, in place: in the disc a robot on the rim facing out
    (no candidate inside: the projection) and one at the centre whose
    first candidate lies at exactly R (kept by ``<=``) with a second one
    valid; in the corridor a robot where every pose and goal candidate is
    within 7 m (candidate 0), three with u_y at 0.4f and its neighbours,
    and one whose first pose and goal candidates lie at exactly 7 m (kept
    by ``>=``); the jitter at 0 and just below 1."""
    spec = env.spec
    below = torch.nextafter(torch.tensor(0.4), torch.tensor(0.0)).item()
    above = torch.nextafter(torch.tensor(0.4), torch.tensor(1.0)).item()
    top = torch.nextafter(torch.tensor(1.0), torch.tensor(0.0)).item()
    if spec.name == "stage1":
        u_pose[:, -1, 0] = torch.tensor([top, 0.0, 0.25])
        u_goal[1, -1, 0] = 0.0
        u_pose[0, -1, 1] = 0.0
        u_goal[:, -1, 1, 0] = torch.tensor([17 / 36, 0.0])  # r = 9 exactly
        u_goal[0, -1, 1, 1] = 0.0                            # r = 8
        return
    if u_jitter is not None:
        u_jitter[-1, :2] = torch.tensor([[0.0, top], [top, 0.0]])
    if u_pose is None:
        return
    i = spec.n_fixed
    cur[-1, i:i + 5] = torch.tensor([[14.0, -3.0, 0.0]] + [[-20.0, 20.0,
                                                            0.0]] * 3
                                    + [[2.0, -1.0, 0.0]])
    for u in (u_pose, u_goal):
        u[0, -1, i] = 0.5                     # x = 14
        u[1, -1, i] = 0.2                     # y = -3
        u[1, -1, i + 1:i + 4, 0] = torch.tensor([below, 0.4, above])
    u_pose[:2, -1, i + 4, 0] = 0.0            # (9, -1): 7 m from (2, -1)
    u_pose[:2, -1, i + 4, 1] = torch.tensor([top, 0.9])
    u_goal[:, -1, i + 4, 0] = torch.tensor([0.7, 0.0])   # (16, -1)
    u_goal[:, -1, i + 4, 1] = torch.tensor([top, 0.9])


@pytest.mark.parametrize("world,arenas", SAMPLE_PATHS)
@pytest.mark.parametrize("standing", [True, False], ids=["cur", "origin"])
def test_sampler_kernel_matches_plain_maps(cuda, world, arenas, standing):
    """``env_cuda.sample`` on the uniforms ``Env._draw`` makes, with the
    edge rows of ``_edge_uniforms``, is the plain maps of
    engine/sampling.py (``Env._sample_plain``) bit for bit, from where the
    robots stand and from the origin; the edge rows pick the candidates
    they were set for.  One launch a call."""
    env = Env(get_world(world), device=cuda, seed=SEED)
    assert env._sampler is env._kernels is not None
    n = env.n_robots
    draws = env._draw(arenas)
    cur = None
    if standing:
        cur = env.sample_pose_goal(arenas)[0]
        cur[..., :2] = cur[..., :2] * 1.5 - 2.0   # off the tables too
    _edge_uniforms(env, *draws, cur if cur is not None else
                   torch.zeros((arenas, n, 3), device=cuda))
    before = [None if t is None else t.clone() for t in (*draws, cur)]
    counts = env_cuda.launches_by_mode.copy()
    got = env_cuda.sample(env._sampler, arenas, *draws, cur)
    want = env._sample_plain(arenas, *draws, cur)
    assert env_cuda.launches_by_mode["env_sample", arenas * n, "float32"] \
        - counts["env_sample", arenas * n, "float32"] == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (g != w).nonzero()[:8].tolist()
    assert all(t is None or torch.equal(t, b)
               for t, b in zip((*draws, cur), before)), "an input written"
    pose, goal = (t[-1].cpu() for t in got)
    if world == "stage1":
        assert pose[0, 0] > 8.99 and bool((goal[0] - torch.tensor(
            [9.0, 0.0])).abs().max() < 1e-5)           # projected
        assert torch.equal(goal[1], torch.tensor([9.0, 0.0]))
    elif world == "stage2" and standing:
        i = env.spec.n_fixed
        assert torch.equal(pose[i, :2], torch.tensor([14.0, -3.0]))
        assert torch.equal(goal[i], torch.tensor([14.0, -3.0]))
        # 0.4f and the float below it take the band y in [-5, -1] (each
        # rounds to -5), the float above takes (-19, -13]
        assert pose[i + 1:i + 4, 1].tolist() == [-5.0, -5.0, -13.0]
        assert torch.equal(pose[i + 4, :2], torch.tensor([9.0, -1.0]))
        assert torch.equal(goal[i + 4], torch.tensor([16.0, -1.0]))


@pytest.mark.parametrize("world,arenas", SAMPLE_PATHS)
def test_kernel_sampler_steps_as_the_plain_sampler(cuda, world, arenas):
    """128 steps of the kernel path with the sampler kernel and with the
    plain maps in its place (``_sampler`` None), each env on its own
    generator from one seed, random actions out of their bounds, and every
    40 steps the first arena timed out as a whole, so that circle_train's
    one group resets too: every field of every step bit-equal, and the
    sampler kernel launched once a step and once in the reset."""
    spec = get_world(world)
    env, plain = (Env(spec, device=cuda, seed=SEED) for _ in range(2))
    plain._sampler = None
    robots = arenas * env.n_robots
    counts = env_cuda.launches_by_mode.copy()
    state, _ = env.reset(arenas)
    pstate, _ = plain.reset(arenas)
    assert all(torch.equal(v, getattr(pstate, k))
               for k, v in vars(state).items())
    g = torch.Generator(device=cuda).manual_seed(1)
    resets = 0
    for t in range(128):
        act = torch.rand((arenas, env.n_robots, 2), generator=g,
                         device=cuda) * 4 - 1.5
        if t % 40 == 20:
            step = torch.where(torch.arange(arenas, device=cuda)[:, None]
                               == 0, spec.timeout, state.step)
            state = dataclasses.replace(state, step=step)
            pstate = dataclasses.replace(pstate, step=step.clone())
        got = _step_fields(env.step(state, act))
        want = _step_fields(plain.step(pstate, act))
        for k, w in want.items():
            assert torch.equal(got[k], w), f"step {t}: {k} differs"
        state, pstate = (EnvState(**{k[6:]: v for k, v in out.items()
                                     if k.startswith("state.")})
                         for out in (got, want))
        resets += int((state.step == 0).sum())
    assert resets > 0
    assert env_cuda.launches_by_mode["env_sample", robots, "float32"] \
        - counts["env_sample", robots, "float32"] == 129


# ---------------------------------------------------------------------------
# bf16 mode (precision="bf16"; its kernels against their plain versions in
# the two trunk tests above)
# ---------------------------------------------------------------------------

def test_trunk_bf16_kernels_refuse_other_dtypes(cuda):
    """No silent cast: float64 scans, bf16 weights or a cotangent of the
    other mode's dtype raise."""
    scans, act, crt, _ = _inputs(cuda, _random(0), 8)
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


def test_trunk_kernels_use_tensor_cores_in_bf16_mode_only(cuda):
    """cuobjdump -sass of the built library: HMMA/HGMMA in every bf16
    product, conv-pass and conv_bwd kernel, none in a float32 kernel."""
    from rl_collision_avoidance_torch.ops import build

    check_sass(sass_mma_counts(read_sass(build.build())))


def test_trunk_float32_mode_unmoved_by_bf16_launches(cuda):
    """The two modes share no mutable state: float32 features and gradients
    bit-equal before and after bf16 launches on the same weights."""
    scans, act, crt, g = _inputs(cuda, _random(4), 1000)

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


# ---------------------------------------------------------------------------
# The acting step's CUDA graphs (utils/graphs.py): the graphed step against
# the same step callable run eagerly (graphs.captured_on patched to False)
# ---------------------------------------------------------------------------

TRAIN_PRESETS = {"stage1": TrainConfig.stage1, "stage2": TrainConfig.stage2}
GRAPH_HORIZON = 16


def _trainer(cuda, world, dtype=torch.float32, arenas=None):
    """A trainer of ``world``'s preset at ``arenas`` arenas, or by default
    2 arenas at GRAPH_HORIZON steps, 4 minibatches x 2 epochs; bf16 policy
    and scans with ``dtype`` bf16."""
    bf16 = dtype == torch.bfloat16
    kw = {"policy_dtype": dtype, "obs_store_dtype": dtype if bf16 else None}
    if arenas is None:
        n = get_world(world).n_robots
        kw.update(n_arenas=2, horizon=GRAPH_HORIZON,
                  ppo=PPOConfig(batch_size=2 * n * GRAPH_HORIZON // 4,
                                epochs=2))
    else:
        kw.update(n_arenas=arenas, seed=SEED)
    return Trainer(TRAIN_PRESETS[world](**kw), device=cuda)


def _three_updates(cuda, world, dtype, inject, arenas):
    """Three updates from a fresh trainer, with the PPO update between the
    rollouts; ``inject``: the action noise and reset samples given (drawn
    from a seeded generator and the env's sampler).  Returns each update's
    metrics, parameters and env state, and a last rollout's trajectory and
    bootstrap value; the rise of the graph counts and of the forward
    kernel's launches; the horizon."""
    tr = _trainer(cuda, world, dtype, arenas)
    state = tr.init_state()
    gen = torch.Generator(device=cuda).manual_seed(11)
    h, a = tr.cfg.horizon, tr.n_local
    counts = (graphs.captures, graphs.replays, trunk_cuda.launches)
    out = []
    for _ in range(3):
        draws = () if not inject else (
            torch.randn((h, a * tr.spec.n_robots, 2), generator=gen,
                        device=cuda),
            [tr.env.sample_pose_goal(a) for _ in range(h)])
        state, m = tr.train_step(state, *draws)
        out += [m, *(v.clone() for v in state.policy.state_dict().values()),
                *(x.clone() for x in vars(state.env_state).values())]
    rises = (graphs.captures - counts[0], graphs.replays - counts[1],
             trunk_cuda.launches - counts[2])
    _, traj, value = tr._rollout(state)
    out += [*(traj[k].clone() for k in sorted(traj)), value]
    return out, rises, h


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


@pytest.mark.parametrize("world,dtype,inject,arenas", [
    ("stage1", torch.float32, True, None),
    ("stage1", torch.float32, False, None),
    ("stage2", torch.float32, True, None),
    ("stage2", torch.float32, False, None),
    ("stage1", torch.bfloat16, False, None),
    ("stage2", torch.bfloat16, True, None),
    ("stage1", torch.float32, False, TRAIN_ARENAS),
    ("stage2", torch.float32, False, S2_ARENAS)], ids=_ids)
def test_graphed_updates_are_the_eager_updates(cuda, monkeypatch, world,
                                               dtype, inject, arenas):
    """Three stage-1 or stage-2 updates with the acting step replayed from
    its graph are the updates with the step run eagerly, bit for bit: every
    metric, parameter and env tensor after each update (so each replay read
    the parameters the PPO update wrote in place), and a fourth rollout;
    in float32 and bf16, on injected draws and on the generators', at 2
    arenas and at the presets' widths.  One capture, then one replay a
    step, which counts the forward it launches: the kernel's launches are
    the eager updates' and the capture's warm-up runs."""
    graphed, rises, horizon = _three_updates(cuda, world, dtype, inject,
                                             arenas)
    assert rises[:2] == (1, 3 * horizon)
    monkeypatch.setattr(graphs, "captured_on", lambda device: False)
    eager, eager_rises, _ = _three_updates(cuda, world, dtype, inject, arenas)
    assert eager_rises[:2] == (0, 0)
    assert rises[2] == eager_rises[2] + graphs.WARMUP
    assert _same(graphed, eager)


def _circle_eval_setup(cuda, arenas):
    from rl_collision_avoidance_torch.eval import circle as circle_eval

    policy = load_policy(CIRCLE_PARAMS, device=cuda)
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


@pytest.mark.parametrize("arenas,max_steps,ends", [(4, 3000, True),
                                                   (EVAL_ARENAS, 300, False)])
def test_graphed_eval_is_the_eager_eval(cuda, monkeypatch, arenas, max_steps,
                                        ends):
    """run_episodes on the circle at 0.1 m of jitter, 4 arenas until the
    eval_check ends it and the eval's 32 for 300 steps: every action handed
    to Env.step and each robot's first result and its step are the eager
    step's, bit for bit."""
    circle_eval, policy, env, noise = _circle_eval_setup(cuda, arenas)
    runs = []
    for graphed in (True, False):
        if not graphed:
            monkeypatch.setattr(graphs, "captured_on", lambda device: False)
        actions = []
        monkeypatch.setattr(env, "step", _stepped(env, actions))
        done, first, start = circle_eval.run_episodes(policy, env, arenas,
                                                      max_steps, noise)
        monkeypatch.undo()
        runs.append([done, first, start, *actions])
    if ends:
        assert bool((runs[0][1] != 0).all())     # every robot has a result
        assert len(runs[0]) - 3 < max_steps      # so the check ended it
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


@pytest.mark.parametrize("world,arenas", [("stage1", None),
                                          ("stage2", S2_ARENAS)])
def test_checkpoint_round_trip_across_graphed_updates(cuda, tmp_path, world,
                                                      arenas):
    """An update with the graphed acting step (stage 1 at 2 arenas, stage 2
    at its preset), a save, two more updates; the save restored into the
    same trainer (a new policy: a new graph key, captured once) gives the
    same two updates bit for bit."""
    from rl_collision_avoidance_torch.utils.checkpoint import (
        CheckpointManager)

    tr = _trainer(cuda, world, arenas=arenas)
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
# The curriculum's paths at their presets' widths, cut in depth, from the
# committed weights: each held by its gates (card_gates), and every kernel
# launch at a batch and mode the kernel tests above hold
# ---------------------------------------------------------------------------

TRAIN_UPDATES = 2     # updates after a warm-up one
EVAL_STEPS = 3000     # the circle eval's step limit (results/circle_eval.json)


def _warm_trainer(cfg, params, cuda):
    tr = Trainer(cfg, device=cuda)
    state = tr.init_state()
    state.policy.load_state_dict(jax_params_to_torch(load_jax_npz(params)))
    return tr, state


def _goal_share(metrics) -> float:
    ended = sum(m["episodes"] for m in metrics)
    assert ended, "no episode ended"
    return sum(m["reached"] for m in metrics) / ended


def _compare_plain_step(env, policy, state, obs):
    """One more acting step of ``state``, the kernel path against the plain
    path (plain trunks, use_kernels=False) on the same draws, both envs
    with the kernel path's action: rewards, poses and dones equal, actions
    within POLICY_ATOL and scans within LIDAR_ATOL; in bf16 by the flip
    rule (a pre-activation or mean one ulp apart; a scan one ulp apart)."""
    from rl_collision_avoidance_torch.models.policy import PRECISION

    precision = PRECISION[policy.dtype]
    plain_env = Env(env.spec, device=env.device, use_kernels=False,
                    obs_dtype=env.obs_dtype, disc_cull_k=env.disc_cull_k,
                    rect_silhouette=env.rect_silhouette)
    a, n = obs.scans.shape[:2]
    noise = torch.randn((a * n, 2), generator=env.generator,
                        device=env.device)
    rp, rg = env.sample_pose_goal(a)
    action, s_k, o_k, r_k, d_k, _ = bench.act_step(env, policy, state, obs,
                                                   noise, None, rp, rg)
    with torch.no_grad():
        feats = trunk_cuda.twin_trunks_plain(
            obs.scans.reshape(a * n, *obs.scans.shape[2:]),
            policy.trunk_weights("act"), policy.trunk_weights("crt"),
            precision)
        _, mean, logstd = policy.heads(feats, obs.goal.reshape(a * n, 2),
                                       obs.speed.reshape(a * n, 2))
        plain_action = (mean + torch.exp(logstd) * noise).reshape(a, n, 2)
    s_p, o_p, r_p, d_p, _ = plain_env.step(state, action, rp, rg)
    d_act = (action - plain_action).abs()
    d_scan = (o_k.scans.float() - o_p.scans.float()).abs()
    assert torch.equal(r_k, r_p) and torch.equal(s_k.pose, s_p.pose)
    assert torch.equal(d_k, d_p)
    if precision == "float32":
        assert float(d_act.max()) <= POLICY_ATOL
        assert float(d_scan.max()) <= LIDAR_ATOL
        return
    # mean = (sigmoid(x0), tanh(x1)), x = w . h + b over the 128 bf16
    # activations h of act_fc2: a rounding of h or of x that falls the
    # other way moves x by at most one ulp of its terms' sum S =
    # |w| . |h| + |b|, so mean by the slope (at most 1/4, 1) times
    # BF16_ULP S, plus one ulp of mean for its own rounding
    with torch.no_grad():
        dt = policy.dtype
        gs = torch.cat([obs.goal, obs.speed], -1).reshape(a * n, 4)
        h = torch.relu(policy.dense(torch.cat([feats[0].to(dt), gs.to(dt)],
                                              -1), policy.act_fc2))
        h = h.double().abs()
        terms = torch.cat([
            h @ head.weight.double().abs().T + head.bias.double().abs()
            for head in (policy.actor1, policy.actor2)], -1)
    slope = torch.tensor([0.25, 1.0], device=terms.device,
                         dtype=torch.float64)
    m = mean.reshape(a, n, 2).double()
    flip_check(d_act, POLICY_ATOL, POLICY_ATOL + BF16_ULP
               * (m.abs() + slope * terms.reshape(a, n, 2)), "bf16 actions")
    assert bool((d_scan <= LIDAR_ATOL
                 + BF16_ULP * o_p.scans.float().abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=_ids)
def test_stage1_acting_slice_on_the_card(cuda, dtype):
    """Stage-1 acting (bench.run_acting; bf16: bench --bf16 --obs-bf16),
    264 steps of ACT_ARENAS arenas of the trained weights: finite, the
    kernels at the path's batch alone, a goal share of at least
    S1_MIN_GOAL, and one more step against the plain path."""
    precision = "bf16" if dtype == torch.bfloat16 else "float32"
    policy = load_policy(PARAMS, device=cuda, dtype=dtype)
    env = Env(stage1(), device=cuda, seed=SEED, obs_dtype=dtype)
    gen = torch.Generator(device=cuda).manual_seed(SEED + 1)
    robots = ACT_ARENAS * env.n_robots
    reset_counts()
    state, obs = env.reset(ACT_ARENAS)
    state, obs, stats = bench.run_acting(env, policy, state, obs, 264, gen)
    assert bool(stats["finite"])
    assert set(read_counts()) == {("lidar_obs", robots, "float32"),
                                  ("twin_trunks", robots, precision),
                                  *env_launches(env, robots, 1)}
    goal, crash, timeout = stats["ends"].tolist()[1:]
    assert goal / (goal + crash + timeout) >= S1_MIN_GOAL
    _compare_plain_step(env, policy, state, obs)


#: The training paths: (preset, arenas, world, precision, warm start,
#: updates, goal floor, float64 rule).
TRAINING_PATHS = {
    "stage1": (TrainConfig.stage1, TRAIN_ARENAS, "stage1", "float32",
               PARAMS, 1 + TRAIN_UPDATES, S1_MIN_GOAL, False),
    "stage1-bf16": (TrainConfig.stage1, TRAIN_ARENAS, "stage1", "bf16",
                    PARAMS, 1 + TRAIN_UPDATES, S1_MIN_GOAL, False),
    "stage2": (TrainConfig.stage2, S2_ARENAS, "stage2", "float32", PARAMS,
               1 + TRAIN_UPDATES, S2_MIN_GOAL, False),
    "stage2-bf16": (TrainConfig.stage2, S2_ARENAS, "stage2", "bf16", PARAMS,
                    TRAIN_UPDATES, S2_MIN_GOAL, False),
    "circle_ft": (TrainConfig.circle_ft, FT_ARENAS, "circle_train",
                  "float32", CIRCLE_PARAMS, 1, None, True),
    "stage1_rect": (TrainConfig.stage1, TRAIN_ARENAS, "stage1_rect",
                    "float32", PARAMS, 1 + TRAIN_UPDATES, S1_MIN_GOAL, False)}


@pytest.mark.parametrize("path", TRAINING_PATHS)
def test_training_path_on_the_card(cuda, path):
    """``updates`` updates of a preset at its width (bf16: --bf16
    --obs-bf16: float32 params, a bf16 rollout buffer), warm-started from
    the committed weights: finite losses, moved parameters, the kernels
    launched as often as the updates launch them, a goal share of the
    ended episodes of at least ``min_goal``, and the minibatch gradients
    held to the plain path's (compare_minibatch_grads; ``f64``: the
    fine-tune's cancelling critic held to float64).  The box footprint
    also takes one acting step against the plain path."""
    preset, arenas, world, precision, params, updates, min_goal, f64 = (
        TRAINING_PATHS[path])
    dtype = trunk_cuda.PRECISIONS[precision]
    cfg = preset(n_arenas=arenas, seed=SEED, world=world, policy_dtype=dtype,
                 obs_store_dtype=None if precision == "float32" else dtype)
    tr, state = _warm_trainer(cfg, params, cuda)
    start = [p.detach().clone() for p in state.policy.parameters()]
    reset_counts()
    metrics = []
    for _ in range(updates):
        state, m = tr.train_step(state)
        metrics.append(m)
    launches = read_counts()
    steps = metrics[0]["env_steps"] // cfg.ppo.batch_size * cfg.ppo.epochs
    assert all(math.isfinite(m[k]) for m in metrics
               for k in ("policy_loss", "value_loss", "entropy"))
    assert max(float((p.detach() - q).abs().max()) for p, q in
               zip(state.policy.parameters(), start)) > 0
    assert launches == training_launches(tr, updates, steps)
    assert set(launches) <= CHECKED
    if min_goal is not None:
        assert _goal_share(metrics) >= min_goal
    assert all(p.dtype == torch.float32 for p in state.policy.parameters())
    _, traj, last_value = tr._rollout(state)
    assert traj["scans"].dtype == (cfg.obs_store_dtype or torch.float32)
    print(f"{world} ({precision}): minibatch samples on other pieces",
          compare_minibatch_grads(tr, state, traj, last_value, f64))
    if tr.env.walls_only:
        _compare_plain_step(tr.env, state.policy, state.env_state,
                            tr.env.obs(state.env_state))


@pytest.mark.parametrize("footprint,cull_k,arenas,noise", [
    ("disc", None, 1, 0.0), ("disc", None, EVAL_ARENAS, 0.1),
    ("rect", None, 1, 0.0), ("rect", RECT_CULL_K, 1, 0.0),
    ("rect", None, RECT_ARENAS, RECT_NOISE)])
def test_circle_eval_on_the_card(cuda, footprint, cull_k, arenas, noise):
    """run_circle_eval with the fine-tuned weights, up to EVAL_STEPS steps:
    the ring, and 32 arenas at 0.1 m (EVAL_MIN_SUCCESS); on the box
    footprint the ring and the ring culled to RECT_CULL_K (RECT_RING), and
    RECT_ARENAS at RECT_NOISE m (RECT_MIN_SUCCESS).  Two graphs captured,
    both replayed each step; the kernels at the eval's batch alone."""
    from rl_collision_avoidance_torch.eval import run_circle_eval

    rect = footprint == "rect"
    spec = dataclasses.replace(circle(), footprint=footprint)
    policy = load_policy(CIRCLE_PARAMS, device=cuda)
    reset_counts()
    metrics = run_circle_eval(
        policy, spec, max_steps=EVAL_STEPS, seed=SEED, n_arenas=arenas,
        pose_noise=noise, env_kwargs=cull_k and {"disc_cull_k": cull_k})
    robots = arenas * spec.n_robots
    launches = read_counts()
    # one forward a step, after the policy graph's warm-up runs
    steps = launches[("twin_trunks", robots, "float32")] - graphs.WARMUP
    lidar = "lidar_obs_walls" if rect else "lidar_obs"
    assert set(launches) == {(lidar, robots, "float32"),
                             ("twin_trunks", robots, "float32"),
                             *(() if rect else
                               [("env_physics", robots, "float32")])}
    assert (graphs.captures, graphs.replays) == (2, 2 * steps)
    if arenas > 1:
        floor = RECT_MIN_SUCCESS if rect else EVAL_MIN_SUCCESS
        assert metrics["success_rate_mean"] >= floor, metrics
    elif rect:
        assert {k: metrics[k] for k in RECT_RING} == RECT_RING, metrics


@pytest.mark.parametrize("precision", ["float32", "bf16"])
def test_two_gloo_ranks_train_on_one_card(cuda, tmp_path, precision):
    """Two ranks sharing the card through gloo (NCCL refuses two ranks on
    one device), each training its half of the stage-1 preset's arenas for
    1 + TRAIN_UPDATES updates from the trained weights: params bit-equal,
    equal global metrics, a goal share of at least MP_MIN_GOAL, each rank's
    kernels launched as its updates launch them."""
    outs = run_ranks("card_train", {
        "precision": precision, "arenas": TRAIN_ARENAS,
        "updates": 1 + TRAIN_UPDATES, "params": str(PARAMS),
        "device": "cuda:0"}, tmp_path, world=RANKS,
        env={"CUDA_VISIBLE_DEVICES": "0"}, timeout=420)
    first, *others = outs
    for out in others:
        assert all(torch.equal(v, out["params"][k])
                   for k, v in first["params"].items())
        assert out["metrics"] == first["metrics"]
    assert _goal_share(first["metrics"]) >= MP_MIN_GOAL
    for out in outs:
        assert out["launches"] == out["want"]
        assert set(out["launches"]) <= CHECKED


def _synthetic_minibatch(m: int, logstd) -> dict:
    """A stage-1 minibatch of ``m`` samples on the CPU: scans uniform over
    the normalized range, actions drawn around random means with the
    policy's std ``logstd`` and their log-probabilities under those means,
    advantages and targets standard normal, 10% of the weights 0."""
    g = torch.Generator().manual_seed(SEED + 5)
    rand = lambda *shape: torch.rand(shape, generator=g)
    normal = lambda *shape: torch.randn(shape, generator=g)
    mu = torch.stack([rand(m), 2 * rand(m) - 1], -1)
    eps = normal(m, 2)
    logprob = (-0.5 * eps ** 2 - 0.5 * math.log(2 * math.pi)
               - logstd).sum(-1, keepdim=True)
    return {"scans": rand(m, 3, 512) - 0.5, "goal": 2 * normal(m, 2),
            "speed": torch.stack([rand(m), 2 * rand(m) - 1], -1),
            "action": mu + logstd.exp() * eps, "logprob": logprob,
            "target": normal(m, 1), "adv": normal(m, 1),
            "weight": (rand(m) > 0.1).float()}


def test_two_gloo_ranks_split_update_on_one_card(cuda, tmp_path):
    """One ppo_update (the stage-1 preset's) of a S1_BATCH-sample minibatch
    split over two gloo ranks on the card against one process's update of
    the whole: the ranks' params bit-equal; each gradient leaf Adam stepped
    on within GRAD_ATOL of its largest value and GRAD_NORM in relative
    2-norm; a parameter whose steps differ by more than lr / 2 has a
    gradient within GRAD_ATOL of zero (Adam's first step moves it by lr g /
    (|g| + eps), so where the gradients agree in sign away from zero the
    params agree to rounding); the value and entropy losses within
    GRAD_NORM."""
    from rl_collision_avoidance_torch.algo.ppo import Batch, ppo_update

    m = S1_BATCH
    cfg = TrainConfig.stage1().ppo._replace(batch_size=m, epochs=1)
    start = jax_params_to_torch(load_jax_npz(PARAMS))
    batch = _synthetic_minibatch(m, start["logstd"].reshape(2))
    outs = run_ranks("ppo", {
        "params": start, "batch": batch, "ppo": cfg._asdict(),
        "perms": torch.arange(m // RANKS).expand(RANKS, 1, -1),
        "device": "cuda:0"}, tmp_path, world=RANKS,
        env={"CUDA_VISIBLE_DEVICES": "0"}, timeout=420)
    got = outs[0]
    assert all(torch.equal(v, out["params"][k]) for out in outs[1:]
               for k, v in got["params"].items())
    policy = CNNPolicy().to(cuda)
    policy.load_state_dict(start)
    out = ppo_update(policy, torch.optim.Adam(policy.parameters(),
                                              lr=cfg.learning_rate),
                     Batch(**{k: v.to(cuda) for k, v in batch.items()}),
                     cfg, torch.arange(m, device=cuda)[None])
    for (name, p), ga in zip(policy.named_parameters(), got["grads"]):
        ga, gb = ga.double(), p.grad.double().cpu()
        scale = float(gb.abs().max())
        assert float((ga - gb).abs().max()) <= GRAD_ATOL * scale, name
        assert float((ga - gb).norm()) <= GRAD_NORM * float(gb.norm()), name
        moved = (got["params"][name] - p.detach().cpu()).abs() > (
            cfg.learning_rate / 2)
        assert not bool((gb[moved].abs() > GRAD_ATOL * scale).any()), name
    for i in (1, 2):                               # value, entropy
        have, ref = float(got["minibatches"][0, i]), float(
            out["minibatches"][0, i])
        assert abs(have - ref) <= GRAD_NORM * abs(ref), (i, have, ref)


def _train_slice(cuda):
    """Stage-1 training at the preset's width from the trained weights,
    1 + TRAIN_UPDATES updates: every metric and the params after."""
    tr, state = _warm_trainer(TrainConfig.stage1(n_arenas=TRAIN_ARENAS,
                                                 seed=SEED), PARAMS, cuda)
    metrics = []
    for _ in range(1 + TRAIN_UPDATES):
        state, m = tr.train_step(state)
        metrics.append(m)
    return [*metrics, *state.policy.state_dict().values()]


# ---------------------------------------------------------------------------
# multi-process training (parallel/dist.py, algo/ppo.py::ppo_update)
# ---------------------------------------------------------------------------


def test_one_rank_nccl_update_is_the_one_process_update(cuda, tmp_path):
    """A one-rank NCCL group, whose all-reduces really run: the stage-1
    training slice at the preset's width (PPO minibatches of 32,768 through
    the trunk kernels) is the slice without a group bit for bit."""
    from rl_collision_avoidance_torch.parallel import (setup_distributed,
                                                       teardown, world_size)

    alone = _train_slice(cuda)
    setup_distributed(f"file://{tmp_path}/store", 1, 0)
    try:
        assert world_size() == 1
        assert torch.distributed.get_backend() == "nccl"
        grouped = _train_slice(cuda)
    finally:
        teardown()
    assert _same(alone, grouped)


def test_nccl_refuses_two_ranks_on_one_card(cuda, tmp_path):
    """Two NCCL ranks that map to one card (one card visible): each rank's
    setup raises the error that says so, and neither hangs."""
    outs = run_ranks("nccl_twice", {}, tmp_path,
                     env={"CUDA_VISIBLE_DEVICES": "0"}, timeout=300)
    for out in outs:
        assert out["error"] and "NCCL takes one rank a device" in out["error"]


# ---------------------------------------------------------------------------
# The entry points: the curriculum, the results pipeline, the world compiler
# ---------------------------------------------------------------------------

CURRICULUM_UPDATES = 2
CURRICULUM_EVAL_STEPS = 300


def _stage_launches(cfg, updates, cuda) -> dict:
    """The launches of ``updates`` updates of a fresh ``cfg`` trainer after
    the reset of its arenas (one more lidar pass and, where the world
    resets, one more sample)."""
    tr = Trainer(cfg, device=cuda)
    steps = (cfg.horizon * tr.n_local * tr.spec.n_robots
             // cfg.ppo.batch_size * cfg.ppo.epochs)
    robots = tr.n_local * tr.spec.n_robots
    want = training_launches(tr, updates, steps)
    want[("lidar_obs", robots, "float32")] += 1
    if ("env_sample", robots, "float32") in want:   # the reset's sample
        want[("env_sample", robots, "float32")] += 1
    return want


def _eval_launches(launches, want, batches) -> None:
    """Beyond the training's ``want``, ``launches`` hold the evals' alone:
    each kernel at each of ``batches`` robots, in float32."""
    assert {k: launches.get(k, 0) for k in want} == want
    assert {k for k in launches if k not in want} == {
        (k, b, "float32") for b in batches
        for k in ("lidar_obs", "twin_trunks", "env_physics")}
    assert set(launches) <= CHECKED


def test_curriculum_on_the_card(cuda, tmp_path):
    """examples/train_curriculum.curriculum at full width, cut in depth
    (CURRICULUM_UPDATES updates a stage, a checkpoint after each, evals of
    CURRICULUM_EVAL_STEPS steps; tests/test_torch_curriculum.py holds its
    files on the CPU): finite params, the eval's shape, the kernels
    launched as the stages' updates and the evals launch them."""
    n_arenas = CURRICULUM_ARENAS
    reset_counts()
    out = train_curriculum.curriculum(
        updates=(CURRICULUM_UPDATES, CURRICULUM_UPDATES), n_arenas=n_arenas,
        checkpoint_every=1, max_steps=CURRICULUM_EVAL_STEPS,
        root=str(tmp_path), device=cuda)
    want = {}
    for stage, arenas in zip(("stage1", "stage2"), n_arenas):
        params = jax_params_to_torch(load_jax_npz(out[f"{stage}_params"]))
        assert all(bool(torch.isfinite(v).all()) for v in params.values())
        want.update(_stage_launches(TRAIN_PRESETS[stage](n_arenas=arenas),
                                    CURRICULUM_UPDATES, cuda))
    ring, jitter = (out["eval"][k] for k in (
        "deterministic_symmetric", f"jitter_{train_curriculum.EVAL_NOISE}m"))
    assert ring["n_robots"] == jitter["n_robots"] == 50
    assert jitter["n_arenas"] == n_arenas[2]
    assert 0.0 <= jitter["success_rate_mean"] <= 1.0
    _eval_launches(read_counts(), want, (50, 50 * n_arenas[2]))


PIPELINE_UPDATES = 2
PIPELINE_EVAL_STEPS = 300


@pytest.mark.parametrize("flags", [[], ["--bf16", "--obs-bf16"], ["--bf16"]],
                         ids=["float32", "bf16", "bf16-f32obs"])
def test_results_pipeline_selection_on_the_card(cuda, tmp_path, monkeypatch,
                                                flags):
    """make_results' main from the fine-tune on, full width and cut in
    depth (PIPELINE_UPDATES updates, a selection eval after each,
    PIPELINE_EVAL_STEPS steps an eval), in float32 and in bf16 with and
    without bf16 scans (tests/test_torch_make_results.py holds its files on
    the CPU): the kept params are the selection eval's that select_score
    ranks first (the earlier on a tie), with the curve and the phase
    record; the kernels launched as the updates and the float32 evals
    launch them."""
    real, calls = make_results.run_circle_eval, []

    def recording(policy, *args, **kwargs):  # the selection evals' inputs
        ev = real(policy, *args, **kwargs)
        if kwargs.get("n_arenas") == SELECT_ARENAS:
            calls.append(({k: v.detach().cpu().clone() for k, v in
                           policy.state_dict().items()}, ev))
        return ev

    monkeypatch.setattr(make_results, "run_circle_eval", recording)
    pd, root = tmp_path / "params", tmp_path / "out"
    pd.mkdir()
    shutil.copy(CIRCLE_PARAMS, pd / "stage2_params.npz")
    reset_counts()
    out = make_results.main([
        "--from-stage", "circle_ft", "--params-dir", str(pd), "--root",
        str(root), "--circle-ft-updates", str(PIPELINE_UPDATES),
        "--select-every", "1", "--eval-steps", str(PIPELINE_EVAL_STEPS),
        "--eval-arenas", str(EVAL_ARENAS), "--no-plots", "--device",
        str(cuda), *flags])
    bf16, obs_bf16 = bool(flags), "--obs-bf16" in flags
    name = ("circle_ft_bf16" + ("" if obs_bf16 else "_f32obs") if bf16
            else "circle_ft")
    record = out["phase"] if bf16 else out["phases"][-1]
    scores = [make_results.select_score(ev) for _, ev in calls]
    assert len(calls) == PIPELINE_UPDATES
    kept = jax_params_to_torch(load_jax_npz(root / f"{name}_params.npz"))
    first_best = calls[scores.index(max(scores))][0]
    assert all(torch.equal(v, first_best[k]) for k, v in kept.items())
    assert all(bool(torch.isfinite(v).all()) for v in kept.values())
    with open(root / f"{name}_circle_curve.csv") as f:
        assert [float(r["circle_success_mean"]) for r in csv.DictReader(f)
                ] == [ev["success_rate_mean"] for _, ev in calls]
    assert record["circle_select_best_score"] == round(max(scores), 4)
    if bf16:
        assert all(math.isfinite(out[k]["success_rate"]) for k in (
            "deterministic", f"jitter_{make_results.BF16_NOISE}m"))
    dtype = torch.bfloat16 if bf16 else torch.float32
    _eval_launches(read_counts(), _stage_launches(TrainConfig.circle_ft(
        n_arenas=FT_ARENAS, policy_dtype=dtype,
        obs_store_dtype=dtype if obs_bf16 else None), PIPELINE_UPDATES, cuda),
        (50, 50 * SELECT_ARENAS, 50 * EVAL_ARENAS, *(() if bf16 else [12])))


def test_compiled_stage1_world_steps_as_the_committed_one(cuda):
    """The world compiler (worlds/compile.py, its PNG reader: the card's
    machine has no image library) rebuilds stage 1, stage 2 and the circle
    rink bit-equal to the committed tables, and one env step of
    TRAIN_ARENAS arenas on the compiled stage-1 world, through the lidar
    kernel, is the step on the committed one, bit for bit."""
    for name in ("stage1", "stage2", "circle"):
        built, table = compile_world(name), get_world(name)
        for f in ("seg_p", "seg_e", "seg_valid"):
            a, b = getattr(built, f), getattr(table, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)
    outs = []
    for spec in (compile_world("stage1"), get_world("stage1")):
        env = Env(spec, device=cuda, seed=SEED)
        state, _ = env.reset(TRAIN_ARENAS)
        act = torch.rand((TRAIN_ARENAS, spec.n_robots, 2), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(
                             SEED + 1)) * 2 - 0.5
        reset_counts()
        outs.append(_step_fields(env.step(state, act)))
        assert read_counts()[("lidar_obs", TRAIN_ARENAS * spec.n_robots,
                              "float32")] == 1
    assert all(torch.equal(v, outs[1][k]) for k, v in outs[0].items())


def test_mlp_policy_on_the_card_matches_the_cpu(cuda):
    """MLPPolicy's forward and the gradients of a mean loss over the acting
    slice's robots' observations (3 x 512 scan beams, goal and speed) on
    the card against the same module on the CPU, within MLP_ATOL (plain
    PyTorch: the JAX package's MLPPolicy has no kernel either)."""
    spec = stage1()
    batch = ACT_ARENAS * spec.n_robots
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        cpu = MLPPolicy(spec.laser_frames * spec.n_beams + 4)
    gpu = copy.deepcopy(cpu).to(cuda)
    obs = torch.randn((batch, spec.laser_frames * spec.n_beams + 4),
                      generator=torch.Generator().manual_seed(SEED))

    def run(policy, x):
        value, mean, logstd = policy(x)
        loss = value.square().mean() + mean.square().mean() + logstd.sum()
        return [value, mean, *torch.autograd.grad(loss,
                                                  list(policy.parameters()))]

    with trunk_cuda.exact_float32():
        got = run(gpu, obs.to(cuda))
    for g, w in zip(got, run(cpu, obs)):
        torch.testing.assert_close(g.detach().cpu(), w.detach(),
                                   atol=MLP_ATOL, rtol=0)
