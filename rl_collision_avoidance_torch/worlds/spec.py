"""World specifications for the port: geometry, sensor and reward constants.

Counterpart of ``rl_collision_avoidance_tpu/worlds/spec.py``, cut to the
worlds the port runs so far (``stage1`` and the small ``mini`` test room).
The stage-1 geometry comes from the committed literal table in
:mod:`.stage1_geometry`, so no world is compiled from an image at run time.
Array members are numpy; :class:`~..engine.env.Env` moves them to its device.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

from .stage1_geometry import SEGMENTS as _STAGE1_SEGMENTS


class ResetMode(enum.Enum):
    """How robots obtain fresh poses/goals when an episode (re)starts."""

    #: Uniform random pose in a disc, goal 8-10 m away (stage_world1.py:251-274).
    RANDOM_DISC = 0
    #: Fixed tables for robots [0, n_fixed); corridor sampler for the rest.
    TABLES_THEN_CORRIDOR = 1
    #: Fixed circle-swap tables, never randomized.
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
    robot_radius: float = 0.22
    footprint: str = "disc"
    n_beams: int = 512
    fov: float = np.pi
    max_range: float = 6.0
    laser_frames: int = 3

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

    @property
    def n_segments(self) -> int:
        return int(self.seg_p.shape[0])


def boundary_segments(sx: float, sy: float):
    """Four border walls (floorplan ``boundary 1``, worlds/stage1.world:27)."""
    hx, hy = sx / 2.0, sy / 2.0
    c = [(-hx, -hy), (hx, -hy), (hx, hy), (-hx, hy)]
    return [(c[i], c[(i + 1) % 4]) for i in range(4)]


def pack_segments(segs, pad_to: int = 128):
    """Pack a segment list into padded (seg_p, seg_e, valid) arrays."""
    n = len(segs)
    total = max(pad_to, ((n + pad_to - 1) // pad_to) * pad_to)
    seg_p = np.zeros((total, 2), dtype=np.float32)
    seg_e = np.zeros((total, 2), dtype=np.float32)
    valid = np.zeros((total,), dtype=bool)
    for i, (p0, p1) in enumerate(segs):
        seg_p[i] = p0
        seg_e[i] = (p1[0] - p0[0], p1[1] - p0[1])
        valid[i] = True
    return seg_p, seg_e, valid


def stage1() -> WorldSpec:
    """24 robots, 20x20 m rounded rink, random poses/goals (worlds/stage1.world)."""
    # Endpoints in double: p0 + e is exact for these f32 values, so
    # pack_segments recovers every e bit for bit.
    seg_p, seg_e, valid = pack_segments(
        [((px, py), (px + ex, py + ey)) for px, py, ex, ey in _STAGE1_SEGMENTS])
    return WorldSpec(name="stage1", n_robots=24, seg_p=seg_p, seg_e=seg_e,
                     seg_valid=valid)


def mini(n_robots: int = 4, n_beams: int = 64) -> WorldSpec:
    """Small square room for fast tests: stage-1 semantics at a fraction of
    the compute (few segments, few beams, few robots)."""
    seg_p, seg_e, valid = pack_segments(boundary_segments(20.0, 20.0))
    return WorldSpec(name="mini", n_robots=n_robots, n_beams=n_beams,
                     seg_p=seg_p, seg_e=seg_e, seg_valid=valid)


def get_world(name: str) -> WorldSpec:
    return {"stage1": stage1, "mini": mini}[name]()
