"""The port's rect footprint (Stage's exact 0.44 x 0.38 m box: collision,
lidar silhouettes, k-nearest culling) against the JAX package, on the CPU
with the same seeded numpy inputs on both sides.

Collision flags are held equal to JAX float32 except where the float64
answer flips when the boxes grow or shrink by EDGE (a pair's gap or overlap
below EDGE): those cases are counted.  Lidar ranges follow the
``torch_parity`` rule (ATOL on normalized obs plus float64 conditioning),
with the boxes' half-dims perturbed by RADIUS_EPS as the disc radius is.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.engine import lidar as jlidar
from rl_collision_avoidance_tpu.engine import physics as jphysics
from rl_collision_avoidance_tpu.engine.celltable import (
    build_cell_table as jbuild_cell_table)
from rl_collision_avoidance_tpu.worlds import get_world as jget_world

from rl_collision_avoidance_torch.engine import lidar, physics
from rl_collision_avoidance_torch.engine.celltable import lookup_cells
from rl_collision_avoidance_torch.engine.env import Env
from rl_collision_avoidance_torch.ops import lidar_cuda
from rl_collision_avoidance_torch.worlds import get_world, stage1_rect
from torch_parity import assert_matches_jax, f64_ranges

T = torch.from_numpy
HL, HW = 0.22, 0.19
EDGE = 1e-5  # m: a collision flag whose float64 margin is below this may flip


# ---------------------------------------------------------------------------
# the world and the wall table
# ---------------------------------------------------------------------------


def test_stage1_rect_world():
    """stage1_rect is stage 1 with the box footprint, field for field the
    JAX package's (tests/test_worlds.py::test_stage1_rect_world)."""
    mine, ref = get_world("stage1_rect"), jget_world("stage1_rect")
    assert mine.name == stage1_rect().name == "stage1_rect"
    assert mine.footprint == "rect" and get_world("stage1").footprint == "disc"
    for f in dataclasses.fields(ref):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "reset_mode":
            assert a.name == b.name
        else:
            assert a == b, f.name
    assert {f.name for f in dataclasses.fields(mine)} == {
        f.name for f in dataclasses.fields(ref)}


@pytest.mark.parametrize("world", ["stage1_rect", "circle"])
def test_rect_wall_table_is_the_jax_one(world):
    """The wall table of a rect world reaches the box's circumradius, as the
    JAX env builds it: the same cells, candidates and counts."""
    spec = dataclasses.replace(get_world(world), footprint="rect")
    reach = float(np.hypot(spec.rect_half_len, spec.rect_half_wid))
    want = jbuild_cell_table(spec.seg_p, spec.seg_e, spec.seg_valid, reach,
                             cell=1.0, pad_multiple=2)
    got = Env(spec, device="cpu").wall_table
    assert got.shape == want.shape and got.k == want.k
    np.testing.assert_array_equal(got.lo, want.lo)
    assert got.cell == want.cell
    np.testing.assert_array_equal(got.table, np.asarray(want.table))
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    disc = Env(dataclasses.replace(spec, footprint="disc"), device="cpu")
    # the disc's reach is shorter: fewer candidates
    assert disc.wall_table.counts.sum() < got.counts.sum()


# ---------------------------------------------------------------------------
# collision
# ---------------------------------------------------------------------------


_rect_wall = jax.jit(jphysics.rect_wall_collision)
_rect_robot = jax.jit(jphysics.rect_robot_collision)


def _jax_collisions(pose, culled, grow=0.0, x64=False):
    """JAX (wall, robot) flags of boxes grown by ``grow`` on each half-dim;
    robots grow by half of it, so that a pair's gap changes by ``grow``."""
    dt = jnp.float64 if x64 else jnp.float32
    p, c = jnp.asarray(pose, dt), jnp.asarray(culled, dt)
    return (np.asarray(_rect_wall(p, c, HL + grow, HW + grow)),
            np.asarray(_rect_robot(p, HL + grow / 2, HW + grow / 2)))


def assert_collisions_match_jax(pose, culled) -> int:
    """The port's flags equal JAX float32's wherever the float64 flag holds
    when the boxes grow and shrink by EDGE; returns the disagreements
    there (ties)."""
    mine = (physics.rect_wall_collision(T(pose), T(culled), HL, HW).numpy(),
            physics.rect_robot_collision(T(pose), HL, HW).numpy())
    ref = _jax_collisions(pose, culled)
    with jax.enable_x64(True):
        grown = _jax_collisions(pose, culled, EDGE, True)
        shrunk = _jax_collisions(pose, culled, -EDGE, True)
    ties = 0
    for what, a, b, g, s in zip(("wall", "robot"), mine, ref, grown, shrunk):
        tie = g != s
        assert not (a != b)[~tie].any(), (what, np.argwhere((a != b) & ~tie))
        ties += int(((a != b) & tie).sum())
    return ties


def _wall_candidates(spec, pose):
    env = Env(spec, device="cpu")
    t = env.wall_table
    return env._wall_cells[lookup_cells(t.lo, t.cell, t.shape,
                                        T(pose[..., :2]))].numpy()


@pytest.mark.parametrize("world", ["stage1_rect", "mini"])
def test_rect_collision_matches_jax_on_seeded_poses(world):
    """Eight arenas: four spread over the whole room (walls), four with the
    robots packed into 3 x 3 m (pairs); both flags of every robot equal to
    JAX float32, with no disagreement at all on these poses."""
    spec = dataclasses.replace(get_world(world), footprint="rect")
    n, rng = spec.n_robots, np.random.default_rng(11)
    half = 10.2 if world == "mini" else 9.8
    pose = np.concatenate([
        np.concatenate([rng.uniform(-half, half, (4, n, 2)),
                        rng.uniform(-np.pi, np.pi, (4, n, 1))], -1),
        np.concatenate([rng.uniform(-1.5, 1.5, (4, n, 2)),
                        rng.uniform(-np.pi, np.pi, (4, n, 1))], -1),
    ]).astype(np.float32)
    culled = _wall_candidates(spec, pose)
    wall = physics.rect_wall_collision(T(pose), T(culled), HL, HW)
    robot = physics.rect_robot_collision(T(pose), HL, HW)
    assert wall[:4].any() and robot[4:].any() and not robot[4:].all()
    ties = assert_collisions_match_jax(pose, culled)
    print(f"{world}: {ties} disagreements within {EDGE} m of a contact")
    assert ties == 0


def test_rect_collision_built_cases():
    """Contacts built on the edge: boxes face to face and a rotated box's
    corner on a face, 1e-6 and 1e-3 m apart or overlapping; a box on a
    wall's end point.  Every flag equals JAX float32 but for ties, and the
    cases 1e-3 m from contact take the side they are on."""
    corner = (HL + HW) * np.sqrt(0.5)   # a 45-degree box's reach along x
    far = 50.0
    # (poses (2, 3), a wall segment (4,) or None for the pair's own test,
    # clear: which side of the contact the case lies on, None for a tie)
    cases = []
    for gap in (1e-3, 1e-6, -1e-6, -1e-3):
        clear = gap > 0
        cases.append(([[0, 0, 0], [2 * HL + gap, 0, 0]],
                      None, clear if abs(gap) > EDGE else None))
        cases.append(([[0, 0, 0], [0, 2 * HW + gap, 0]],
                      None, clear if abs(gap) > EDGE else None))
        cases.append(([[0, 0, 0],
                       [HL + corner + gap, 0, np.pi / 4]],
                      None, clear if abs(gap) > EDGE else None))
        # walls: a face and a 45-degree corner on a wall, a wall's end point
        # on the front face, a segment that starts at the corner and points
        # away along its diagonal
        for seg, pose0 in (([HL + gap, -1.0, 0.0, 2.0], [0, 0, 0]),
                           ([corner + gap, -1.0, 0.0, 2.0],
                            [0, 0, np.pi / 4]),
                           ([HL + gap, 0.0, 1.0, 0.0], [0, 0, 0]),
                           ([HL + gap, HW + gap, 1.0, 1.0],
                            [0, 0, 0])):
            cases.append(([pose0, [far, far, 0]], seg,
                          clear if abs(gap) > EDGE else None))
    pose = np.asarray([c[0] for c in cases], np.float32)
    culled = np.zeros((len(cases), 2, 1, 4), np.float32)
    culled[..., :2] = 1e7           # padding: far away, e = 0
    for i, (_, seg, _) in enumerate(cases):
        if seg is not None:
            culled[i, 0, 0] = seg
    ties = assert_collisions_match_jax(pose, culled)
    wall = physics.rect_wall_collision(T(pose), T(culled), HL, HW).numpy()
    robot = physics.rect_robot_collision(T(pose), HL, HW).numpy()
    for i, (_, seg, clear) in enumerate(cases):
        if clear is None:
            continue
        got = wall[i, 0] if seg is not None else robot[i, 0]
        assert got == (not clear), (i, cases[i])
        if seg is None:
            assert robot[i, 1] == robot[i, 0]
    print(f"built cases: {ties} disagreements within {EDGE} m of a contact")


def test_rect_collision_discriminates_from_disc():
    """tests/test_physics.py's rect cases: the box's 0.19 half-width clears
    a wall and a neighbour that the 0.22 disc touches; head-on 0.43 apart
    the boxes overlap; one turned 90 degrees at 0.42 they clear."""
    seg = lambda *s: torch.tensor([[[s]]], dtype=torch.float32)
    pose = torch.tensor([[[0.0, 0.0, 0.0]]])
    side, front = seg(-1.0, 0.20, 2.0, 0.0), seg(0.21, -1.0, 0.0, 2.0)
    assert not physics.rect_wall_collision(pose, side, HL, HW)[0, 0]
    assert physics.wall_collision_packed(pose[..., :2], side, 0.22)[0, 0]
    assert physics.rect_wall_collision(pose, front, HL, HW)[0, 0]
    turned = torch.tensor([[[0.0, 0.0, np.pi / 2]]])
    assert physics.rect_wall_collision(turned, side, HL, HW)[0, 0]
    assert not physics.rect_wall_collision(turned, front, HL, HW)[0, 0]
    pair = lambda x, y, th: torch.tensor([[[0.0, 0.0, 0.0], [x, y, th]]])
    assert not physics.rect_robot_collision(pair(0.0, 0.39, 0.0), HL,
                                            HW).any()
    assert physics.robot_collision(pair(0.0, 0.39, 0.0)[..., :2], 0.22).any()
    assert physics.rect_robot_collision(pair(0.43, 0.0, 0.0), HL, HW).all()
    assert not physics.rect_robot_collision(pair(0.42, 0.0, np.pi / 2), HL,
                                            HW).any()


# ---------------------------------------------------------------------------
# lidar: box silhouettes and culling
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def silhouette_fn(max_range, radius, disc_k=None, rect=None):
    """JAX raycast_culled(pose, dirs, culled, r) with the boxes' half-dims
    moved as far as the disc radius ``r`` moves from ``radius``, for
    f64_ranges' RADIUS_EPS perturbation (jitted: one compile for its nine
    evaluations)."""
    @jax.jit
    def fn(pose, dirs, culled, r):
        dims = None if rect is None else (rect[0] + (r - radius),
                                          rect[1] + (r - radius))
        return jlidar.raycast_culled(pose, dirs, culled, r, max_range,
                                     disc_k=disc_k, rect=dims)
    return fn


def _stage1_poses(arenas, seed, spread=6.0):
    spec = stage1_rect()
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(-spread, spread, (arenas, spec.n_robots, 2)),
        rng.uniform(-np.pi, np.pi, (arenas, spec.n_robots, 1))],
        -1).astype(np.float32)


def _culled_lidar(env, pose):
    t = env.lidar_table
    return t.table[lookup_cells(t.lo, t.cell, t.shape,
                                T(pose[..., :2])).numpy()]


@pytest.mark.parametrize("disc_k,rect", [(None, True), (5, True), (23, True),
                                         (5, False), (23, False)])
def test_raycast_culled_rect_and_disc_k_match_jax(disc_k, rect):
    """raycast_culled(disc_k=, rect=) on three stage-1 arenas with the
    robots packed into 12 x 12 m (many within range of each other)."""
    env = Env(stage1_rect(), device="cpu")
    s = env.spec
    pose = _stage1_poses(3, seed=5)
    culled = _culled_lidar(env, pose)
    dims = (HL, HW) if rect else None
    mine = lidar.raycast_culled(T(pose), env.local_dirs, T(culled),
                                s.robot_radius, s.max_range, disc_k=disc_k,
                                rect=dims).numpy()
    ref = jlidar.raycast_culled(jnp.asarray(pose), env.local_dirs.numpy(),
                                jnp.asarray(culled), s.robot_radius,
                                s.max_range, disc_k=disc_k, rect=dims)
    fn = silhouette_fn(s.max_range, s.robot_radius, disc_k, dims)
    assert_matches_jax(mine, np.asarray(ref),
                       *f64_ranges(fn, pose, env.local_dirs.numpy(), culled,
                                   radius=s.robot_radius), s.max_range)
    assert (mine < 1.0).any()


@pytest.mark.parametrize("culled_k", [None, 3, 7])
def test_raycast_boxes_match_jax(culled_k):
    """raycast_boxes and raycast_boxes_culled on eight robots in 6 x 6 m,
    two arenas, before the clip."""
    pose = _stage1_poses(2, seed=8, spread=3.0)[:, :8]
    dirs = lidar.beam_directions_local(64, np.pi)
    dx, dy = lidar.rotate_beams(T(pose[..., 2]), T(dirs))
    args = (HL, HW) if culled_k is None else (HL, HW, culled_k)
    mine_fn = lidar.raycast_boxes if culled_k is None else \
        lidar.raycast_boxes_culled
    ref_fn = jlidar.raycast_boxes if culled_k is None else \
        jlidar.raycast_boxes_culled
    mine = mine_fn(T(pose), dx, dy, *args).clamp_max(6.0).numpy()
    ref = np.minimum(np.asarray(ref_fn(jnp.asarray(pose), dx.numpy(),
                                       dy.numpy(), *args)), 6.0)

    @jax.jit
    def fn(p, d, unused, r):
        th = p[..., 2]
        c, s = jnp.cos(th)[..., None], jnp.sin(th)[..., None]
        bx = c * d[:, 0] - s * d[:, 1]
        by = s * d[:, 0] + c * d[:, 1]
        grow = r - 0.22
        extra = () if culled_k is None else (culled_k,)
        return jnp.minimum(ref_fn(p, bx, by, HL + grow, HW + grow, *extra),
                           6.0)

    assert_matches_jax(mine, ref, *f64_ranges(fn, pose, dirs, np.zeros(1),
                                              radius=0.22), 6.0)
    assert (mine < 6.0).any()


def test_scan_rect_matches_jax():
    """The dense scan with box silhouettes, one stage-1 arena."""
    s = stage1_rect()
    pose = _stage1_poses(1, seed=2)[0]
    dirs = lidar.beam_directions_local(s.n_beams, s.fov)
    geo = (s.seg_p, s.seg_e, s.seg_valid)
    mine = lidar.scan(T(pose), T(dirs), *map(T, geo), s.robot_radius,
                      s.max_range, rect=(HL, HW)).numpy()
    ref = jlidar.scan(jnp.asarray(pose), dirs, *geo, s.robot_radius,
                      s.max_range, rect=(HL, HW))

    @jax.jit
    def fn(p, d, sp, se, sv, r):
        grow = r - s.robot_radius
        return jlidar.scan(p, d, sp, se, sv, r, s.max_range,
                           rect=(HL + grow, HW + grow))

    assert_matches_jax(mine, np.asarray(ref),
                       *f64_ranges(fn, pose, dirs, *geo,
                                   radius=s.robot_radius), s.max_range)


def test_rect_silhouette_analytic():
    """tests/test_lidar.py::test_rect_silhouette_analytic: head-on the beam
    meets the box's face at 3 - hl, with the box turned 90 degrees its side
    at 3 - hw."""
    s = get_world("mini")
    dirs = T(lidar.beam_directions_local(64, np.pi))
    geo = [T(a) for a in (s.seg_p, s.seg_e, s.seg_valid)]
    for th, want in ((np.pi, 3.0 - HL), (np.pi / 2, 3.0 - HW)):
        pose = torch.tensor([[0.0, 0.0, 0.0], [3.0, 0.0, th]])
        r = lidar.scan(pose, dirs, *geo, 0.22, 6.0, rect=(HL, HW))
        assert abs(float(r[0, 32]) - want) < 0.02
        if th == np.pi:
            assert abs(float(r[1, 32]) - want) < 0.02


def _spread_ring(n):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([9.0 * np.cos(ang), 9.0 * np.sin(ang), ang],
                    -1).astype(np.float32)[None]


@pytest.mark.parametrize("rect", [False, True])
def test_cull_exact_when_k_covers_neighbors(rect):
    """tests/test_lidar.py::test_disc_cull_exact_when_k_covers_neighbors and
    ::test_rect_cull_exact_when_k_covers_neighbors: k = N - 1 gives the
    dense result to the last bit on a packed cluster, and robots spread
    beyond max_range are exact at any k."""
    spec = stage1_rect() if rect else get_world("stage1")
    n = spec.n_robots
    exact = Env(spec, device="cpu")
    cluster = T(_stage1_poses(2, seed=3, spread=4.0))
    for k, pose in ((n - 1, cluster), (4, T(_spread_ring(n))),
                    (1, T(_spread_ring(n)))):
        culled = Env(spec, device="cpu", disc_cull_k=k)
        assert culled.walls_only
        assert torch.equal(culled.scan_obs(pose), exact.scan_obs(pose)), k
    dx, dy = lidar.rotate_beams(cluster[..., 2], exact.local_dirs)
    dense = lidar.raycast_robots(cluster, dx, dy, spec.robot_radius,
                                 rect=(HL, HW) if rect else None)
    assert torch.equal(lidar.raycast_robots(
        cluster, dx, dy, spec.robot_radius, n - 1,
        (HL, HW) if rect else None), dense)
    with pytest.raises(ValueError, match="cull k"):
        lidar.raycast_boxes_culled(cluster, dx, dy, HL, HW, n)


@pytest.mark.parametrize("disc_k,rect", [(None, True), (6, True), (6, False)])
def test_walls_only_plain_combines_to_raycast_culled(disc_k, rect):
    """lidar_obs_plain(discs=False), combined with the normalized
    silhouettes by a minimum as the env does, is raycast_culled(rect=,
    disc_k=) normalized, to the last bit."""
    spec = stage1_rect() if rect else get_world("stage1")
    env = Env(spec, device="cpu", disc_cull_k=disc_k)
    t, m = env.lidar_table, spec.max_range
    pose = T(_stage1_poses(2, seed=4, spread=5.0))
    walls = lidar_cuda.lidar_obs_plain(pose, env._lidar_cells, t.lo, t.cell,
                                       t.shape, env.local_dirs,
                                       spec.robot_radius, m, discs=False)
    culled = env._lidar_cells[lookup_cells(t.lo, t.cell, t.shape,
                                           pose[..., :2])]
    dims = (HL, HW) if rect else None
    want = lidar.raycast_culled(pose, env.local_dirs, culled,
                                spec.robot_radius, m, disc_k, dims) / m - 0.5
    got = env.scan_obs(pose)
    assert torch.equal(got, want)
    assert (walls >= got).all() and (walls > got).any()
    dx, dy = lidar.rotate_beams(pose[..., 2], env.local_dirs)
    only = lidar.raycast_walls(pose, dx, dy, culled).clamp_max(m) / m - 0.5
    assert torch.equal(walls, only)


def assert_any_frame_matches_jax(env, mine, ref, pose):
    """torch_parity.assert_frame_matches_jax for the env's silhouettes
    (boxes and/or disc_cull_k) with the box half-dims perturbed."""
    s = env.spec
    fn = silhouette_fn(s.max_range, s.robot_radius, env.disc_cull_k,
                       (s.rect_half_len, s.rect_half_wid)
                       if env.rect_silhouette else None)
    m = s.max_range
    culled = _culled_lidar(env, pose)
    assert_matches_jax((mine + 0.5) * m, (ref + 0.5) * m,
                       *f64_ranges(fn, pose, env.local_dirs.numpy(), culled,
                                   radius=s.robot_radius), m)
