"""The port's lidar (plain PyTorch, the CPU side of ops/lidar_cuda.py)
against the JAX package's: the culled and dense raycasts, the Pallas kernel
in interpret mode, and the cell tables, on mini and stage1 poses, held as
``torch_parity.assert_matches_jax`` says."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.engine import lidar as jlidar
from rl_collision_avoidance_tpu.engine.celltable import (
    build_cell_table as jbuild_cell_table, lookup_cells as jlookup_cells)
from rl_collision_avoidance_tpu.ops.lidar_pallas import make_scan_fn
from rl_collision_avoidance_tpu.worlds import mini as jmini
from rl_collision_avoidance_tpu.worlds import stage1 as jstage1

from rl_collision_avoidance_torch.engine import lidar
from rl_collision_avoidance_torch.engine.celltable import (build_cell_table,
                                                           lookup_cells)
from rl_collision_avoidance_torch.ops import lidar_cuda
from rl_collision_avoidance_torch.worlds import mini, stage1
from torch_parity import ATOL, assert_matches_jax, f64_ranges

WORLDS = {"mini": (mini, jmini), "stage1": (stage1, jstage1)}


def _poses(spec, arenas, seed):
    """Uniform poses in the spawn area, plus per arena one robot 0.3 m from
    a wall and a pair of robots 0.6 m apart."""
    rng = np.random.default_rng(seed)
    pose = np.empty((arenas, spec.n_robots, 3), np.float32)
    pose[..., :2] = rng.uniform(-9.0, 9.0, (arenas, spec.n_robots, 2))
    pose[..., 2] = rng.uniform(-np.pi, np.pi, (arenas, spec.n_robots))
    pose[:, 0, :2] = [9.3, 0.2]        # east wall: x = 10 (mini), 9.6 (stage1)
    if spec.name == "mini":
        pose[:, 0, 0] = 9.7
    pose[:, 2, :2] = pose[:, 1, :2] + [0.6, 0.0]
    return pose


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request):
    spec, jspec = (f() for f in WORLDS[request.param])
    table = build_cell_table(spec.seg_p, spec.seg_e, spec.seg_valid,
                             spec.max_range, pad_multiple=8)
    dirs = lidar.beam_directions_local(spec.n_beams, spec.fov)
    pose = _poses(spec, 2, seed=len(request.param))
    cells = lookup_cells(table.lo, table.cell, table.shape,
                         torch.from_numpy(pose[..., :2]))
    culled = table.table[cells.numpy()]                      # (A, N, K, 4)
    return spec, jspec, table, dirs, pose, culled


def test_cell_tables_match_jax(world):
    spec, jspec, table, _, pose, _ = world
    for pad, reach in ((8, spec.max_range), (2, spec.robot_radius)):
        mine = build_cell_table(spec.seg_p, spec.seg_e, spec.seg_valid, reach,
                                pad_multiple=pad)
        ref = jbuild_cell_table(jspec.seg_p, jspec.seg_e, jspec.seg_valid,
                                reach, pad_multiple=pad)
        np.testing.assert_array_equal(mine.table, ref.table)
        np.testing.assert_array_equal(mine.counts, ref.counts)
        np.testing.assert_array_equal(mine.lo, ref.lo)
        assert (mine.cell, mine.shape) == (ref.cell, ref.shape)
    ref = jbuild_cell_table(jspec.seg_p, jspec.seg_e, jspec.seg_valid,
                            jspec.max_range)
    pos = pose[..., :2].reshape(-1, 2)
    np.testing.assert_array_equal(
        lookup_cells(table.lo, table.cell, table.shape,
                     torch.from_numpy(pos)).numpy(),
        np.asarray(jlookup_cells(ref, jnp.asarray(pos))))


def test_raycast_culled_matches_jax(world):
    spec, _, _, dirs, pose, culled = world
    mine = lidar.raycast_culled(torch.from_numpy(pose), torch.from_numpy(dirs),
                                torch.from_numpy(culled), spec.robot_radius,
                                spec.max_range)
    ref = jlidar.raycast_culled(jnp.asarray(pose), jnp.asarray(dirs),
                                jnp.asarray(culled), spec.robot_radius,
                                spec.max_range)
    culled_f64 = lambda *a: jlidar.raycast_culled(*a, spec.max_range)
    assert_matches_jax(mine.numpy(), ref,
                       *f64_ranges(culled_f64, pose, dirs, culled,
                                   radius=spec.robot_radius), spec.max_range)


def test_dense_scan_matches_jax(world):
    spec, _, _, dirs, pose, _ = world
    for p in pose:
        mine = lidar.scan(torch.from_numpy(p), torch.from_numpy(dirs),
                          torch.from_numpy(spec.seg_p),
                          torch.from_numpy(spec.seg_e),
                          torch.from_numpy(spec.seg_valid),
                          spec.robot_radius, spec.max_range)
        args = (dirs, spec.seg_p, spec.seg_e, spec.seg_valid)
        dense = lambda *a: jlidar.scan(*a, spec.max_range)
        ref = jax.jit(dense, static_argnums=5)(*map(jnp.asarray, (p, *args)),
                                               spec.robot_radius)
        assert_matches_jax(mine.numpy(), ref,
                           *f64_ranges(dense, p, *args,
                                       radius=spec.robot_radius),
                           spec.max_range)


def test_lidar_obs_matches_pallas_interpret(world):
    """The wrapper on CPU tensors (its plain version: lookup, gather,
    raycast_culled, normalize) against the TPU kernel run in interpret mode
    on the same culled segments."""
    spec, _, table, dirs, pose, culled = world
    before = lidar_cuda.launches
    mine = lidar_cuda.lidar_obs(torch.from_numpy(pose),
                                torch.from_numpy(table.table), table.lo,
                                table.cell, table.shape,
                                torch.from_numpy(dirs), spec.robot_radius,
                                spec.max_range)
    assert lidar_cuda.launches == before  # the CPU path launches nothing
    scan_fn = make_scan_fn(spec.n_beams, spec.fov, spec.robot_radius,
                           spec.max_range, interpret=True)
    ref = scan_fn(jnp.asarray(pose), jnp.swapaxes(jnp.asarray(culled), 1, 2))
    culled_f64 = lambda *a: jlidar.raycast_culled(*a, spec.max_range)
    assert_matches_jax((mine.numpy() + 0.5) * spec.max_range, ref,
                       *f64_ranges(culled_f64, pose, dirs, culled,
                                   radius=spec.robot_radius), spec.max_range)


def test_culled_matches_dense(world):
    """The culling contract: the cell-table path sees every segment the
    dense scan sees."""
    spec, _, table, dirs, pose, _ = world
    culled_obs = lidar_cuda.lidar_obs_plain(
        torch.from_numpy(pose), torch.from_numpy(table.table), table.lo,
        table.cell, table.shape, torch.from_numpy(dirs), spec.robot_radius,
        spec.max_range)
    dense = torch.stack([lidar.scan(
        torch.from_numpy(p), torch.from_numpy(dirs),
        torch.from_numpy(spec.seg_p), torch.from_numpy(spec.seg_e),
        torch.from_numpy(spec.seg_valid), spec.robot_radius, spec.max_range)
        for p in pose])
    np.testing.assert_allclose(culled_obs.numpy(),
                               dense.numpy() / spec.max_range - 0.5, atol=ATOL)
    assert (dense < spec.max_range).any()  # the poses do see walls
