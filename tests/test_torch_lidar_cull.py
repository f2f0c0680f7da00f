"""The lidar kernel's culling rules (``ops/lidar_cuda.py``: ``live_slots``,
``disc_kept``) against the plain version's own float32 tests, on the CPU.

Each rule drops candidates the kernel never tests.  It is conservative if
every candidate that the plain version hits below ``max_range`` is kept: a
hit at or beyond it is clipped to ``max_range`` either way.  The tests
evaluate ``engine/lidar.py::raycast_culled`` on one candidate at a time (one
segment slot for a lone robot, or one other robot's disc in a two-robot
arena), which does the same float32 operations on the same operands as the
whole arena does, and hold each rule to every hit; then they take the
minimum over the kept candidates only and hold it bit-equal to
``lidar_obs_plain``.  Poses: seeded stage-1 and ``mini`` arenas, a 50-robot
arena on the stage-1 walls, robots on wall lines looking along them, and
``adversarial_poses`` (overlapping discs, pairs 2r apart, tangent beams,
discs at max_range + r and at the far cut, the field-of-view edges, robots
beyond wall ends) with 24 and 50 robots; on the stage-2 map (K = 72) its
reset poses (tables and corridor draws), robots on its wall lines and its
adversarial arena; in the 60 m circle rink the 50-robot ring at step 0 and
pushed out to 28.5 m by the walls, the ring drawn in to 4 m (discs 0.28 m
apart), both with random headings as robots that finished spin in place,
robots on the rink's wall lines and its adversarial arena."""
import math

import numpy as np
import pytest
import torch

from rl_collision_avoidance_torch.engine.celltable import lookup_cells
from rl_collision_avoidance_torch.engine.env import Env
from rl_collision_avoidance_torch.engine.lidar import raycast_culled
from rl_collision_avoidance_torch.ops import lidar_cuda
from rl_collision_avoidance_torch.worlds import circle, mini, stage1, stage2

DEGENERATE = (1e7, 1e7, 0.0, 0.0)   # a padding slot of the cell table


def _stage1_arenas(env, arenas):
    """Seeded spawn-disc poses, plus per arena one robot 0.3-0.5 m from the
    east wall facing it and a pair 0.5-0.7 m apart (as chip_smoke.py)."""
    pose, _ = env.sample_pose_goal(arenas)
    u = torch.rand((arenas, 4), generator=env.generator)
    pose[:, 0, 0] = 9.6 - 0.3 - 0.2 * u[:, 0]
    pose[:, 0, 1] = 2.0 * u[:, 1] - 1.0
    pose[:, 0, 2] = 0.5 * u[:, 2] - 0.25
    ang = 2 * math.pi * u[:, 2]
    gap = 0.5 + 0.2 * u[:, 3]
    pose[:, 2, 0] = pose[:, 1, 0] + gap * torch.cos(ang)
    pose[:, 2, 1] = pose[:, 1, 1] + gap * torch.sin(ang)
    return pose


def _grazing(env, n, seed):
    """(1, n, 3): robots on the lines of random walls of the world, beyond
    the walls' ends by 0-3 m and 1e-7 to 3e-2 m off the line (either side),
    each looking back along its wall within +-0.05 rad."""
    rng = np.random.default_rng(seed)
    s = env.spec
    valid = np.asarray(s.seg_valid, bool)
    p, e = (np.asarray(a, np.float64)[valid] for a in (s.seg_p, s.seg_e))
    i = rng.integers(0, len(p), n)
    u = e[i] / np.hypot(e[i, 0], e[i, 1])[:, None]
    far_end = rng.random(n) < 0.5
    end = np.where(far_end[:, None], p[i] + e[i], p[i])
    out = np.where(far_end, 1.0, -1.0)[:, None] * u   # away from the wall
    off = 10.0 ** rng.uniform(-7, -1.5, n) * rng.choice([-1.0, 1.0], n)
    xy = (end + rng.uniform(0.0, 3.0, n)[:, None] * out
          + off[:, None] * np.stack([-u[:, 1], u[:, 0]], -1))
    look = np.arctan2(-out[:, 1], -out[:, 0]) + rng.uniform(-0.05, 0.05, n)
    return torch.from_numpy(np.concatenate([xy, look[:, None]], -1)
                            .astype(np.float32)[None])


def _case(name):
    """(Env on the CPU, (A, N, 3) float32 poses) of one pose set."""
    if name == "mini":
        env = Env(mini(), device="cpu", seed=5)
        return env, env.sample_pose_goal(6)[0]
    if name.startswith("stage2"):
        env = Env(stage2(), device="cpu", seed=8)
        if name == "stage2":
            return env, env.sample_pose_goal(2)[0]
        if name == "stage2_grazing":
            return env, torch.cat([_grazing(env, 44, seed) for seed in
                                   range(2)])
    if name.startswith("circle"):
        env = Env(circle(), device="cpu", seed=9)
        ring = env.sample_pose_goal(1)[0]
        spun = ring.clone()                 # finished robots spin in place
        spun[..., 2] = 2 * math.pi * torch.rand(spun.shape[:2],
                                                generator=env.generator)
        if name == "circle_ring":           # at step 0, and out by the walls
            return env, torch.cat([ring, spun * torch.tensor(
                [28.5 / 25.0, 28.5 / 25.0, 1.0])])
        if name == "circle_drawn_in":       # discs 0.28 m apart, and walls
            return env, torch.cat([spun * torch.tensor([0.16, 0.16, 1.0]),
                                   _grazing(env, 50, 0)])
    env = Env(stage1(), device="cpu", seed=7)
    if name == "stage1":
        return env, _stage1_arenas(env, 3)
    if name == "walls50":
        rng = np.random.default_rng(50)
        pose = np.empty((1, 50, 3), np.float32)
        pose[..., :2] = rng.uniform(-9.7, 9.7, (1, 50, 2))
        pose[..., 2] = rng.uniform(-np.pi, np.pi, (1, 50))
        return env, torch.from_numpy(pose)
    if name == "grazing":
        return env, torch.cat([_grazing(env, 40, seed) for seed in range(3)])
    n = int(name.split("adversarial")[1])
    return env, torch.from_numpy(lidar_cuda.adversarial_poses(env.spec, n,
                                                              seed=n))


CASES = ("stage1", "mini", "walls50", "grazing", "adversarial24",
         "adversarial50", "stage2", "stage2_grazing", "stage2_adversarial44",
         "circle_ring", "circle_drawn_in", "circle_adversarial50")


def _pairs(n):
    i, j = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    keep = i != j
    return i[keep], j[keep]


@pytest.fixture(scope="module", params=CASES)
def ranges(request):
    """Per-candidate clipped ranges of one pose set and what each rule keeps:
    segments (A, N, K, B), discs (A, P, B) for the P ordered pairs (viewer i,
    disc j), viewer-major; the rules (A, N, K, 1) and (A, P, 1)."""
    env, pose = _case(request.param)
    s, t = env.spec, env.lidar_table
    table, dirs = env._lidar_cells, env.local_dirs
    a, n, _ = pose.shape
    cells = lookup_cells(t.lo, t.cell, t.shape, pose[..., :2])
    culled = table[cells]                                    # (A, N, K, 4)
    k = culled.shape[2]
    lone = pose[:, :, None, None, :].expand(a, n, k, 1, 3).reshape(-1, 1, 3)
    seg = raycast_culled(lone, dirs, culled.reshape(-1, 1, 1, 4),
                         s.robot_radius, s.max_range).reshape(a, n, k, -1)
    i, j = _pairs(n)
    pair = torch.stack([pose[:, i], pose[:, j]], dim=2).reshape(-1, 2, 3)
    empty = torch.tensor(DEGENERATE).expand(pair.shape[0], 2, 1, 4)
    disc = raycast_culled(pair, dirs, empty, s.robot_radius,
                          s.max_range)[:, 0].reshape(a, len(i), -1)
    oc = pose[:, j, :2] - pose[:, i, :2]
    c2 = (oc * oc).sum(-1) - s.robot_radius * s.robot_radius
    return dict(env=env, pose=pose, seg=seg, disc=disc,
                slots=lidar_cuda.live_slots(table)[cells][..., None],
                discs=lidar_cuda.disc_kept(c2, s.robot_radius,
                                           s.max_range)[..., None])


@pytest.mark.parametrize("rule,kind", [("slots", "seg"), ("discs", "disc")])
def test_rule_keeps_every_hit(ranges, rule, kind):
    """Every candidate the plain version hits below max_range, the rule
    keeps."""
    hit = ranges[kind] < ranges["env"].spec.max_range
    assert hit.any()
    assert not (hit & ~ranges[rule]).any()


def test_rules_do_cull(ranges):
    """Both rules drop something on these poses."""
    assert not ranges["slots"].all()
    assert not ranges["discs"].all()


@pytest.mark.parametrize("rules", [("slots",), ("discs",),
                                   ("slots", "discs")])
def test_culled_scan_is_bit_equal_to_plain(ranges, rules):
    """The minimum over the candidates the kernel keeps, clipped and
    normalized, is lidar_obs_plain's output to the last bit."""
    env, pose = ranges["env"], ranges["pose"]
    s, t = env.spec, env.lidar_table
    top = torch.tensor(s.max_range)
    seg, disc = ranges["seg"], ranges["disc"]
    if "slots" in rules:
        seg = torch.where(ranges["slots"], seg, top)
    if "discs" in rules:
        disc = torch.where(ranges["discs"], disc, top)
    a, n = pose.shape[:2]
    by_viewer = disc.reshape(a, n, n - 1, -1).amin(dim=2)
    got = torch.minimum(seg.amin(dim=2), by_viewer) / s.max_range - 0.5
    want = lidar_cuda.lidar_obs_plain(pose, env._lidar_cells, t.lo, t.cell,
                                      t.shape, env.local_dirs,
                                      s.robot_radius, s.max_range)
    assert torch.equal(got, want)


@pytest.mark.parametrize("make_spec", [stage1, mini])
def test_live_slots_are_the_cell_counts(make_spec):
    """Only the padding has e = 0: the live slots of each cell are its
    ``counts`` valid segments, first in the row."""
    t = Env(make_spec(), device="cpu").lidar_table
    live = lidar_cuda.live_slots(torch.from_numpy(t.table))
    np.testing.assert_array_equal(live.sum(-1).numpy(), t.counts)
    first = torch.arange(t.k)[None, :] < torch.from_numpy(t.counts)[:, None]
    assert torch.equal(live, first)


def _disc_trials(dist, spread, radius, max_range, seed, beams=16):
    """Two-robot arenas: the viewer at a random float32 origin in the
    stage-1 rink, the disc's centre at ``dist`` (M,) from it, the viewer's
    ``beams`` beams fanned over +-``spread`` radians around the line to the
    centre (jittered by a random share of the fan's step).  -> (M, beams)
    clipped ranges of the viewer against that disc, and the (M,) float32
    c2 as the plain version computes it."""
    g = torch.Generator().manual_seed(seed)
    m = dist.shape[0]
    u = torch.rand((4, m), generator=g, dtype=torch.float64)
    o = (u[:2].T - 0.5) * 16.0
    phi = 2 * math.pi * u[2]
    pose = torch.zeros((m, 2, 3), dtype=torch.float64)
    pose[:, 0, :2] = o
    pose[:, 0, 2] = phi + (2 * u[3] - 1) * (spread / beams + 1e-4)
    pose[:, 1, :2] = o + dist[:, None] * torch.stack([phi.cos(), phi.sin()],
                                                     -1)
    pose = pose.float()
    fan = torch.linspace(-spread, spread, beams, dtype=torch.float64)
    dirs = torch.stack([fan.cos(), fan.sin()], -1).float()
    empty = torch.tensor(DEGENERATE).expand(m, 2, 1, 4)
    r = raycast_culled(pose, dirs, empty, radius, max_range)[:, 0]
    oc = pose[:, 1, :2] - pose[:, 0, :2]
    return r, (oc * oc).sum(-1) - radius * radius


@pytest.mark.parametrize("scale", [1e-7, 1e-5, 1e-3])
def test_disc_with_origin_inside_never_hits(scale):
    """c2 <= 0 (the origin inside or on the other disc): no beam hits it in
    float32, over 40,000 origins within ``scale`` of the radius of the
    disc's centre, beams around the centre's direction."""
    s = stage1()
    m = 40_000
    g = torch.Generator().manual_seed(int(-math.log10(scale)))
    dist = s.robot_radius * (1 - scale * torch.rand(m, generator=g,
                                                    dtype=torch.float64))
    r, c2 = _disc_trials(dist, 0.5, s.robot_radius, s.max_range, seed=m)
    inside = c2 <= 0
    assert inside.sum() > m // 4
    assert (r[inside] == s.max_range).all()
    assert not lidar_cuda.disc_kept(c2, s.robot_radius, s.max_range)[
        inside].any()


@pytest.mark.parametrize("spread", [0.0, 0.04, 1.2])
def test_disc_beyond_far_cut_never_hits_in_range(spread):
    """c2 >= far_disc_c2: no beam hits it below max_range in float32, over
    40,000 discs just past the cut, beams head-on (spread 0), near the
    tangent (0.04 rad, the disc's half-width there) and wide."""
    s = stage1()
    reach = math.sqrt(lidar_cuda.far_disc_c2(s.robot_radius, s.max_range)
                      + s.robot_radius ** 2)
    m = 40_000
    g = torch.Generator().manual_seed(3)
    dist = reach * (1 + 1e-4 * torch.rand(m, generator=g,
                                          dtype=torch.float64))
    r, c2 = _disc_trials(dist, spread, s.robot_radius, s.max_range,
                         seed=int(spread * 100))
    far = ~lidar_cuda.disc_kept(c2, s.robot_radius, s.max_range)
    assert far.sum() > m // 2
    assert (r[far] == s.max_range).all()
    # the same trials with max_range moved past the discs do hit them, so
    # the beams reach them and only the clip hides the hits
    r_open, _ = _disc_trials(dist, spread, s.robot_radius, 2 * reach,
                             seed=int(spread * 100))
    assert (r_open < 2 * reach).any()


def test_adversarial_poses_shape_and_limits():
    s = stage1()
    pose = lidar_cuda.adversarial_poses(s, 24)
    assert pose.shape == (1, 24, 3) and pose.dtype == np.float32
    xy = torch.from_numpy(pose[0, :, :2])
    d = torch.cdist(xy.double(), xy.double())
    assert (d[0, 1:] < s.robot_radius).any()          # an overlapping disc
    with pytest.raises(ValueError):
        lidar_cuda.adversarial_poses(s, 23)
