"""World specifications for the port: geometry, sensor and reward constants.

Counterpart of ``rl_collision_avoidance_tpu/worlds/spec.py``: the
curriculum's worlds ``stage1``, ``stage2``, ``circle`` and
``circle_train``, ``stage1_rect`` (stage 1 with Stage's exact box
footprint), and the small ``mini`` test room.  The worlds read their wall
geometry from the committed literal tables in :mod:`.stage1_geometry`,
:mod:`.stage2_geometry` and :mod:`.circle_geometry`, so that building one
is fast and reads no image.  Those tables are what the world compiler
(:mod:`.compile`) gives for the Stage bitmaps in ``assets/`` and the stage-2
polygon obstacles: :func:`compile_world` rebuilds a world's geometry that
way, bit for bit the same.  Array members are numpy;
:class:`~..engine.env.Env` moves them to its device.
"""
from __future__ import annotations

import dataclasses
import enum
import os

import numpy as np

from .circle_geometry import SEGMENTS as _RINK60_SEGMENTS
from .compile import (boundary_segments, pack_segments, polygon_segments,
                      segments_from_bitmap)
from .stage1_geometry import SEGMENTS as _STAGE1_SEGMENTS
from .stage2_geometry import SEGMENTS as _STAGE2_SEGMENTS

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")


class ResetMode(enum.Enum):
    """How robots obtain fresh poses/goals when an episode (re)starts."""

    #: Uniform random pose in a disc, goal 8-10 m away (stage_world1.py:251-274).
    RANDOM_DISC = 0
    #: Fixed tables for robots [0, n_fixed); corridor sampler for the rest
    #: (stage_world2.py:210-214, 164-168, 250-287).
    TABLES_THEN_CORRIDOR = 1
    #: Fixed circle-swap tables, never randomized (circle_world.py:205-208).
    FIXED_TABLES = 2


@dataclasses.dataclass(frozen=True)
class WorldSpec:
    """Immutable, host-side description of one workload's world."""

    name: str
    n_robots: int

    # static geometry, padded to a fixed segment count
    seg_p: np.ndarray  # (S, 2) f32 segment start points
    seg_e: np.ndarray  # (S, 2) f32 segment edge vectors (end - start)
    seg_valid: np.ndarray  # (S,) bool padding mask

    # robot / sensor constants (worlds/stage1.world:8-15,83)
    robot_radius: float = 0.22  # disc approximation of the 0.44 x 0.38 box
    # Collision footprint: "disc" (robot_radius, the fast default) or "rect",
    # Stage's exact 0.44 x 0.38 m oriented box (stage1.world:83), for wall
    # and robot-robot collision and, by default, the lidar silhouettes.
    footprint: str = "disc"
    rect_half_len: float = 0.22  # half of `size [0.44 0.38 0.22]` x
    rect_half_wid: float = 0.19  # half of its y
    n_beams: int = 512
    fov: float = np.pi
    max_range: float = 6.0
    laser_frames: int = 3
    # Observation beam count after the reference's sparse left/right
    # resample (stage_world1.py:122-140); None = all n_beams.
    obs_beams: int | None = None

    dt: float = 0.1
    substeps: int = 1

    # reward / termination (stage_world1.py:180-211)
    goal_size: float = 0.5
    omega_thresh: float = 1.05
    timeout: int = 150
    dist_prev_zero_on_reset: bool = False

    reset_mode: ResetMode = ResetMode.RANDOM_DISC
    spawn_radius: float = 9.0
    goal_dist_min: float = 8.0
    goal_dist_max: float = 10.0
    # Scenario tables (unused entries are zero): (N, 3) poses, (N, 2) goals
    init_pose_table: np.ndarray | None = None
    goal_table: np.ndarray | None = None
    n_fixed: int = 0  # robots [0, n_fixed) use the tables in TABLES_THEN_CORRIDOR
    # Uniform +-pose_jitter (m) added per robot to the table x/y at every
    # reset (the circle_train world); 0.0 = exact tables.
    pose_jitter: float = 0.0
    # Episode-synchronization groups (model/utils.py:81-87): group id per
    # robot, or None when episodes are per-robot independent.
    group_id: np.ndarray | None = None

    @property
    def n_segments(self) -> int:
        return int(self.seg_p.shape[0])


def _unpack(rows):
    """Padded (seg_p, seg_e, valid) of a committed geometry table.
    Endpoints in double: p0 + e is exact for these f32 values, so
    pack_segments recovers every e bit for bit."""
    return pack_segments([((px, py), (px + ex, py + ey))
                          for px, py, ex, ey in rows])


def circle_tables(n: int = 50, radius: float = 25.0):
    """Circle-swap scenario (model/utils.py:6-38): n robots on a ring of
    ``radius``, facing the centre, each bound for the antipode.  The
    reference's coordinates are these rounded to 2 decimals."""
    k = np.arange(n)
    ang = k * (2.0 * np.pi / n)
    x = np.round(radius * np.cos(ang), 2)
    y = np.round(radius * np.sin(ang), 2)
    theta = np.pi * (n / 2.0 + k) / (n / 2.0)  # pi + 2*pi*k/n, facing center
    poses = np.stack([x, y, theta], axis=-1).astype(np.float32)
    goals = np.stack([-x, -y], axis=-1).astype(np.float32)
    return poses, goals


def stage2_tables():
    """44-robot structured scenario (model/utils.py:41-63): robots 0-33
    have fixed start poses and goals in six groups (two door swaps, two
    corridor files, a crossing and a 10-robot circle); 34-43 spawn in the
    south-east corridor at random.  Returns (poses (44, 3), goals (44, 2),
    group ids (44,))."""
    pi = np.pi
    poses = np.array(
        [
            [-7.00, 11.50, pi], [-7.00, 9.50, pi], [-18.00, 11.50, 0.0],
            [-18.00, 9.50, 0.0], [-12.50, 17.00, pi * 3 / 2], [-12.50, 4.00, pi / 2],
            [-2.00, 16.00, -pi / 2], [0.00, 16.00, -pi / 2], [3.00, 16.00, -pi / 2],
            [5.00, 16.00, -pi / 2], [10.00, 4.00, pi / 2], [12.00, 4.00, pi / 2],
            [14.00, 4.00, pi / 2], [16.00, 4.00, pi / 2], [18.00, 4.00, pi / 2],
            [-2.5, -2.5, 0.0], [-0.5, -2.5, 0.0], [3.5, -2.5, pi], [5.5, -2.5, pi],
            [-2.5, -18.5, pi / 2], [-0.5, -18.5, pi / 2], [1.5, -18.5, pi / 2],
            [3.5, -18.5, pi / 2], [5.5, -18.5, pi / 2],
            [-6.00, -10.00, pi], [-7.15, -6.47, pi * 6 / 5], [-10.15, -4.29, pi * 7 / 5],
            [-13.85, -4.29, pi * 8 / 5], [-16.85, -6.47, pi * 9 / 5],
            [-18.00, -10.00, pi * 2], [-16.85, -13.53, pi * 11 / 5],
            [-13.85, -15.71, pi * 12 / 5], [-10.15, -15.71, pi * 13 / 5],
            [-7.15, -13.53, pi * 14 / 5],
            [10.00, -17.00, pi / 2], [12.00, -17.00, pi / 2], [14.00, -17.00, pi / 2],
            [16.00, -17.00, pi / 2], [18.00, -17.00, pi / 2],
            [10.00, -2.00, -pi / 2], [12.00, -2.00, -pi / 2], [14.00, -2.00, -pi / 2],
            [16.00, -2.00, -pi / 2], [18.00, -2.00, -pi / 2],
        ],
        dtype=np.float32,
    )
    goals = np.zeros((44, 2), dtype=np.float32)
    goals[:34] = np.array(
        [
            [-18.0, 11.5], [-18.0, 9.5], [-7.0, 11.5], [-7.0, 9.5],
            [-12.5, 4.0], [-12.5, 17.0],
            [-2.0, 3.0], [0.0, 3.0], [3.0, 3.0], [5.0, 3.0],
            [10.0, 10.0], [12.0, 10.0], [14.0, 10.0], [16.0, 10.0], [18.0, 10.0],
            [3.5, -2.5], [5.5, -2.5], [-2.5, -2.5], [-0.5, -2.5],
            [-2.5, -5.5], [-0.5, -5.5], [1.5, -5.5], [3.5, -5.5], [5.5, -5.5],
            [-18.0, -10.0], [-16.85, -13.53], [-13.85, -15.71], [-10.15, -15.71],
            [-7.15, -13.53], [-6.00, -10.00], [-7.15, -6.47], [-10.15, -4.29],
            [-13.85, -4.29], [-16.85, -6.47],
        ],
        dtype=np.float32,
    )
    # Group boundaries [0, 6, 10, 15, 19, 24, 34, 44] (model/utils.py:83)
    bounds = [0, 6, 10, 15, 19, 24, 34, 44]
    group_id = np.zeros(44, dtype=np.int32)
    for g in range(len(bounds) - 1):
        group_id[bounds[g]:bounds[g + 1]] = g
    return poses, goals, group_id


# Stage's ray-trace resolution, the geometry granularity of the reference
# simulator (worlds/stage1.world:3 `resolution 0.2`).
_STAGE_RESOLUTION = 0.2


def _bitmap_world_segments(png: str, size_m: float,
                           resolution: float = _STAGE_RESOLUTION,
                           simplify_tol: float | None = None,
                           reach_seeds=None):
    """The wall segments of the square bitmap world ``assets/<png>`` of
    ``size_m`` meters a side, as the JAX package's ``_bitmap_world_segments``
    compiles them.

    ``reach_seeds``: world points robots can reach; the space outside their
    free component is filled solid (exact: it can never be seen or
    touched), which also covers the floorplan's ``boundary 1`` walls.
    ``simplify_tol`` defaults to the raster resolution: chords within one
    raster cell of the contour stay inside Stage's own granularity and cut
    the segment count (stage-1 rink: 154 -> 27)."""
    if simplify_tol is None:
        simplify_tol = resolution
    segs = segments_from_bitmap(os.path.join(_ASSETS, png), (size_m, size_m),
                                resolution, simplify_tol, reach_seeds)
    if reach_seeds is None:
        segs += boundary_segments(size_m, size_m)  # floorplan `boundary 1`
    return segs


def _stage2_obstacle_segments():
    """The nine polygon obstacles of worlds/stage2.world:168-296: Stage
    normalizes block points to their bounding box and scales them into the
    model `size` (0.7 x 0.7 m) centered at `pose`."""
    obstacles = [
        ((12, -9), [(0, 0), (0, 1), (0.75, 1), (1, 0.75), (1, 0.25), (0.75, 0)]),
        ((16, -7), [(0.225, 0.0), (0.208, 0.086), (0.159, 0.159), (0.086, 0.208),
                    (0.0, 0.225), (-0.086, 0.208), (-0.159, 0.159), (-0.208, 0.086),
                    (-0.225, 0.0), (-0.208, -0.086), (-0.159, -0.159), (-0.086, -0.208),
                    (-0.0, -0.225), (0.086, -0.208), (0.159, -0.159), (0.208, -0.086)]),
        ((17, -9), [(-0.02, -0.077), (0.078, -0.077), (0.078, 0.077), (-0.02, 0.077)]),
        ((14, -11), [(-3, -1.5), (-3, 0.5), (-2, 1.5), (2, 1.5), (3, 0.5), (3, -1.5)]),
        ((10, -10), [(-3, -1.5), (-3, 0.5), (-2, 1.5), (2, 0.7), (3, 0.5), (3, 0)]),
        ((13, -7), [(0, -1.5), (0, 0.5), (0.5, -0.5), (1, 0.4), (2, -0.5), (0.5, -1)]),
        ((10, -7), [(0, 0), (0.3, 0.5), (0, 1), (0.4, 0.7), (0.5, 0)]),
        ((18, -11), [(-3, -1.5), (-3, 0.5), (-2, 1.5), (2, 0.7), (3, 0.5), (3, 0)]),
        ((15, -9), [(0, -1.5), (0, 0.5), (0.5, -0.5), (1, 0.4), (2, -0.5), (0.5, -1)]),
    ]
    segs = []
    for pose, pts in obstacles:
        segs += polygon_segments(pts, size=(0.7, 0.7), center=pose)
    return segs


def _stage2_segments():
    """testenv.png at 40 m with every scenario pose, goal and corridor seed
    as a reach seed, then the polygon obstacles (the JAX ``stage2()``)."""
    poses, goals, _ = stage2_tables()
    seeds = [tuple(p[:2]) for p in poses] + [tuple(g) for g in goals[:34]]
    seeds += [(14.0, -3.0), (14.0, -16.0)]  # corridor spawn band
    return (_bitmap_world_segments("testenv.png", 40.0, reach_seeds=seeds)
            + _stage2_obstacle_segments())


def _rink_segments(size_m: float):
    return _bitmap_world_segments("rink.png", size_m,
                                  reach_seeds=[(0.0, 0.0)])


#: Each world's geometry as the compiler builds it from its sources.
_SOURCES = {"stage1": lambda: _rink_segments(20.0),
            "stage1_rect": lambda: _rink_segments(20.0),
            "stage2": _stage2_segments,
            "circle": lambda: _rink_segments(60.0),
            "circle_train": lambda: _rink_segments(60.0),
            "mini": lambda: boundary_segments(20.0, 20.0)}


def compile_world(name: str) -> WorldSpec:
    """The world ``name`` with its wall geometry compiled from its sources
    (bitmap, reach seeds, polygons) instead of read from the committed
    table; the two are equal bit for bit."""
    seg_p, seg_e, valid = pack_segments(_SOURCES[name]())
    return dataclasses.replace(get_world(name), seg_p=seg_p, seg_e=seg_e,
                               seg_valid=valid)


def stage1() -> WorldSpec:
    """24 robots, 20x20 m rounded rink, random poses/goals (worlds/stage1.world)."""
    seg_p, seg_e, valid = _unpack(_STAGE1_SEGMENTS)
    return WorldSpec(name="stage1", n_robots=24, seg_p=seg_p, seg_e=seg_e,
                     seg_valid=valid)


def stage2() -> WorldSpec:
    """44 robots, 40x40 m multi-room map + polygon obstacles
    (worlds/stage2.world); six table groups and ten corridor robots."""
    poses, goals, group_id = stage2_tables()
    seg_p, seg_e, valid = _unpack(_STAGE2_SEGMENTS)
    return WorldSpec(
        name="stage2", n_robots=44, seg_p=seg_p, seg_e=seg_e,
        seg_valid=valid, timeout=200,
        reset_mode=ResetMode.TABLES_THEN_CORRIDOR, init_pose_table=poses,
        goal_table=goals, n_fixed=34, group_id=group_id,
        dist_prev_zero_on_reset=True)


def circle(n_robots: int = 50) -> WorldSpec:
    """``n_robots``-robot circle swap in a 60x60 m rink (worlds/circle.world);
    the evaluation world: fixed tables, never reset."""
    seg_p, seg_e, valid = _unpack(_RINK60_SEGMENTS)
    poses, goals = circle_tables(n_robots)
    return WorldSpec(
        name="circle", n_robots=n_robots, seg_p=seg_p, seg_e=seg_e,
        seg_valid=valid, timeout=10000,
        omega_thresh=0.7,  # circle_world.py:195
        reset_mode=ResetMode.FIXED_TABLES, init_pose_table=poses,
        goal_table=goals, n_fixed=n_robots, dist_prev_zero_on_reset=True)


def circle_train(n_robots: int = 50, pose_jitter: float = 0.6,
                 timeout: int = 700) -> WorldSpec:
    """The circle swap as a training world (the stage-3 fine-tune of the
    JAX package): the geometry and tables of :func:`circle`, one reset
    group (all robots done -> a fresh ring), table x/y jittered by uniform
    +-``pose_jitter`` at every reset, a finite timeout, and the true
    distance as the first "previous distance"."""
    seg_p, seg_e, valid = _unpack(_RINK60_SEGMENTS)
    poses, goals = circle_tables(n_robots)
    return WorldSpec(
        name="circle_train", n_robots=n_robots, seg_p=seg_p, seg_e=seg_e,
        seg_valid=valid, timeout=timeout, omega_thresh=0.7,
        reset_mode=ResetMode.TABLES_THEN_CORRIDOR, init_pose_table=poses,
        goal_table=goals, n_fixed=n_robots,
        group_id=np.zeros(n_robots, dtype=np.int32),
        pose_jitter=pose_jitter, dist_prev_zero_on_reset=False)


def mini(n_robots: int = 4, n_beams: int = 64) -> WorldSpec:
    """Small square room for fast tests: stage-1 semantics at a fraction of
    the compute (few segments, few beams, few robots)."""
    seg_p, seg_e, valid = pack_segments(boundary_segments(20.0, 20.0))
    return WorldSpec(name="mini", n_robots=n_robots, n_beams=n_beams,
                     seg_p=seg_p, seg_e=seg_e, seg_valid=valid)


def stage1_rect() -> WorldSpec:
    """Stage 1 under Stage's exact footprint, the 0.44 x 0.38 m oriented box
    (worlds/stage1.world:83), for collision and lidar silhouettes; the
    geometry, scenario and reward of :func:`stage1`."""
    return dataclasses.replace(stage1(), name="stage1_rect", footprint="rect")


def get_world(name: str) -> WorldSpec:
    return {"stage1": stage1, "stage2": stage2, "circle": circle,
            "circle_train": circle_train, "mini": mini,
            "stage1_rect": stage1_rect}[name]()
