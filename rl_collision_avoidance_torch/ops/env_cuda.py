"""The env-step kernels' wrapper and the rule that chooses them.

``Env.step`` runs its plain PyTorch chain (``engine/env.py::Env._step_plain``)
or, where :func:`kernel_path` says so, :func:`physics` and
:func:`reset_apply`: the hand-written kernels in ``csrc/env_step.cu``, which
do the whole step but the reset sampler and the lidar in one launch
(``FIXED_TABLES``) or two, with the sampler between them.  On the same
path, in the worlds that reset, ``Env.sample_pose_goal`` maps its uniforms
with :func:`sample`, one more launch.  There is no fallback between the
kernels and the plain chain: a CUDA tensor that the kernels cannot take
raises.  The box footprint's separating-axis tests are another algorithm,
and rect worlds keep the plain chain.

The kernels never write their inputs: each step's outputs are new tensors,
views of one fresh buffer per dtype (float32, bool, int32, int64).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..utils import graphs
from ..worlds.spec import ResetMode
from . import build

#: Kernel launches since the count was last set to 0.
launches = 0
#: The same launches by (kernel, robots, "float32"): "env_physics" for the
#: step up to the reset mask, "env_reset" for the reset apply, "env_sample"
#: for the reset sampler.
launches_by_mode: collections.Counter = collections.Counter()


def kernel_path(device, use_kernels: bool, footprint: str) -> bool:
    """Rule: the env steps through the kernels when ``use_kernels`` is set,
    it lives on a CUDA device and its robots are discs."""
    return (use_kernels and torch.device(device).type == "cuda"
            and footprint == "disc")


class EnvConsts(ctypes.Structure):
    """A world's constants as ``csrc/env_step.cu`` reads them."""
    _fields_ = [("wall", ctypes.c_void_p), ("group_id", ctypes.c_void_p),
                ("k", ctypes.c_int), ("nx", ctypes.c_int),
                ("ny", ctypes.c_int), ("lo_x", ctypes.c_float),
                ("lo_y", ctypes.c_float), ("inv_cell", ctypes.c_float),
                ("n", ctypes.c_int), ("mode", ctypes.c_int),
                ("substeps", ctypes.c_int), ("timeout", ctypes.c_int),
                ("dist_zero", ctypes.c_int), ("h", ctypes.c_float),
                ("radius_sq", ctypes.c_float), ("diam_sq", ctypes.c_float),
                ("goal_size", ctypes.c_float), ("omega", ctypes.c_float),
                ("pose_table", ctypes.c_void_p),
                ("goal_table", ctypes.c_void_p), ("n_fixed", ctypes.c_int),
                ("spawn_r", ctypes.c_float), ("dmin_sq", ctypes.c_float),
                ("d_span", ctypes.c_float), ("jitter", ctypes.c_float)]


@dataclasses.dataclass
class World:
    """The constants of one env's world, and the device tensors they point
    into (kept alive here)."""
    consts: EnvConsts
    wall: torch.Tensor
    group_id: torch.Tensor | None
    tables: tuple[torch.Tensor, torch.Tensor] | None
    fixed: bool


def world(spec, wall_cells: torch.Tensor, wall_table) -> World:
    """The kernels' view of ``spec`` with its wall-cell table
    ``wall_cells`` (C, K, 4) on the card, built as ``wall_table`` says."""
    if not 1 <= spec.n_robots <= 1024:
        raise ValueError(f"the env-step kernel takes 1 to 1024 robots an "
                         f"arena, not {spec.n_robots}")
    wall = wall_cells.contiguous()
    group_id = None
    if spec.reset_mode is ResetMode.TABLES_THEN_CORRIDOR:
        # dense ids, so that a block's flag array has one slot a group
        dense = np.unique(np.asarray(spec.group_id), return_inverse=True)[1]
        group_id = torch.as_tensor(dense.reshape(-1), dtype=torch.int32,
                                   device=wall.device)
    tables = None
    if spec.reset_mode is not ResetMode.RANDOM_DISC:
        tables = tuple(torch.as_tensor(t, dtype=torch.float32,
                                       device=wall.device).contiguous()
                       for t in (spec.init_pose_table, spec.goal_table))
    lo = np.asarray(wall_table.lo, np.float32)
    dmin, dmax = spec.goal_dist_min, spec.goal_dist_max
    consts = EnvConsts(
        wall=wall.data_ptr(),
        group_id=None if group_id is None else group_id.data_ptr(),
        k=wall_table.k, nx=wall_table.shape[0], ny=wall_table.shape[1],
        lo_x=float(lo[0]), lo_y=float(lo[1]),
        # PyTorch divides by a scalar as a product with its reciprocal
        inv_cell=float(np.float32(1.0) / np.float32(wall_table.cell)),
        n=spec.n_robots, mode=spec.reset_mode.value, substeps=spec.substeps,
        timeout=spec.timeout, dist_zero=int(spec.dist_prev_zero_on_reset),
        h=spec.dt / spec.substeps, radius_sq=spec.robot_radius ** 2,
        diam_sq=(2.0 * spec.robot_radius) ** 2, goal_size=spec.goal_size,
        omega=spec.omega_thresh,
        pose_table=None if tables is None else tables[0].data_ptr(),
        goal_table=None if tables is None else tables[1].data_ptr(),
        n_fixed=spec.n_fixed, spawn_r=spec.spawn_radius,
        # the scalars engine/sampling.py computes in Python, then rounds
        dmin_sq=dmin * dmin, d_span=dmax * dmax - dmin * dmin,
        jitter=spec.pose_jitter)
    return World(consts, wall, group_id, tables,
                 spec.reset_mode is ResetMode.FIXED_TABLES)


@dataclasses.dataclass
class Step:
    """One step's outputs, (A, N, ...) views of the step's buffers.
    ``phys_pose`` is the pose before any reset (where the reset sampler
    draws from), ``reset`` the reset mask."""
    pose: torch.Tensor
    phys_pose: torch.Tensor
    speed: torch.Tensor
    goal: torch.Tensor
    obs_goal: torch.Tensor
    dist: torch.Tensor
    ep_return: torch.Tensor
    reward: torch.Tensor
    info_return: torch.Tensor
    dead: torch.Tensor
    done: torch.Tensor
    valid: torch.Tensor
    reached: torch.Tensor
    crashed: torch.Tensor
    reset: torch.Tensor
    step: torch.Tensor
    result: torch.Tensor
    floats: torch.Tensor     # the buffers the kernels write
    bools: torch.Tensor


_P, _I = ctypes.c_void_p, ctypes.c_int
#: Each C entry point's arguments: the constants, the arena count, the
#: tensors' pointers, the device and the stream.
_ARGTYPES = {"env_physics_launch": [_P, _I] + [_P] * 11 + [_I, _P],
             "env_reset_launch": [_P, _I] + [_P] * 5 + [_I, _P],
             "env_sample_launch": [_P, _I, _I] + [_P] * 5 + [_I, _P]}


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    fn = getattr(build.library(), name)
    fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    return fn


def _require(cond: bool, msg) -> None:
    if not cond:
        raise ValueError(f"env step kernel: {msg()}")


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def _count(kernel: str, robots: int) -> None:
    global launches
    launches += 1
    launches_by_mode[kernel, robots, "float32"] += 1


def physics(w: World, state, action: torch.Tensor) -> Step:
    """Steps 1-3 of ``Env.step`` on the card in one launch: actions,
    integration, collisions, reward, termination and the reset mask of
    ``state`` (an ``EnvState``) under ``action`` (A, N, 2).  A world that
    never resets is done; otherwise :func:`reset_apply` follows with the
    sample drawn at ``phys_pose``."""
    pose = state.pose
    a, n = pose.shape[0], w.consts.n
    inputs = (pose, state.goal, state.dist, state.step, state.dead,
              state.ep_return, action)
    _require(tuple(t.dtype for t in inputs)
             == (_F32, _F32, _F32, _I32, _BOOL, _F32, _F32),
             lambda: "dtypes " + str([t.dtype for t in inputs]))
    _require(all(t.device == w.wall.device for t in inputs),
             lambda: f"an input is not on {w.wall.device}")
    _require(pose.shape == (a, n, 3) and action.shape == (a, n, 2),
             lambda: f"pose {tuple(pose.shape)}, action "
             f"{tuple(action.shape)} for {n} robots an arena")
    _require(a > 0, lambda: "no arena")
    inputs = [t.contiguous() for t in inputs]
    dev, m = pose.device, a * n
    floats = torch.empty(16 * m, dtype=_F32, device=dev)
    bools = torch.empty((6, a, n), dtype=_BOOL, device=dev)
    step = torch.empty((a, n), dtype=_I32, device=dev)
    result = torch.empty((a, n), dtype=torch.int64, device=dev)
    status = _launcher("env_physics_launch")(
        ctypes.addressof(w.consts), a, *(t.data_ptr() for t in inputs),
        floats.data_ptr(), bools.data_ptr(), step.data_ptr(),
        result.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "env_physics")
    graphs.launched(_count, "env_physics", m)
    poses, pairs, scalars = floats.split([6 * m, 6 * m, 4 * m])
    pose, phys = poses.view(2, a, n, 3).unbind(0)
    speed, goal, obs_goal = pairs.view(3, a, n, 2).unbind(0)
    dist, ep_return, reward, info_return = scalars.view(4, a, n).unbind(0)
    return Step(pose, phys, speed, goal, obs_goal, dist, ep_return, reward,
                info_return, *bools.unbind(0), step, result, floats, bools)


def reset_apply(w: World, out: Step, reset_pose: torch.Tensor,
                reset_goal: torch.Tensor) -> None:
    """Steps 4-5 of ``Env.step`` on the card, into ``out``'s buffers: the
    robots under ``out.reset`` take ``reset_pose`` (A, N, 3) and
    ``reset_goal`` (A, N, 2), their first distance, and a zero counter,
    speed and return."""
    a, n = out.reset.shape
    _require(reset_pose.shape == (a, n, 3) and reset_goal.shape == (a, n, 2)
             and reset_pose.dtype == reset_goal.dtype == _F32
             and reset_pose.device == reset_goal.device == w.wall.device,
             lambda: f"reset sample {tuple(reset_pose.shape)} "
             f"{reset_pose.dtype}, {tuple(reset_goal.shape)} "
             f"{reset_goal.dtype} on {reset_pose.device}")
    reset_pose, reset_goal = reset_pose.contiguous(), reset_goal.contiguous()
    dev = out.floats.device
    status = _launcher("env_reset_launch")(
        ctypes.addressof(w.consts), a, reset_pose.data_ptr(),
        reset_goal.data_ptr(), out.floats.data_ptr(), out.bools.data_ptr(),
        out.step.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "env_reset")
    graphs.launched(_count, "env_reset", a * n)


def sample(w: World, arenas: int, u_pose: torch.Tensor | None,
           u_goal: torch.Tensor | None, u_jitter: torch.Tensor | None = None,
           cur_pose: torch.Tensor | None = None):
    """``Env.sample_pose_goal``'s maps on the card in one launch, bit-equal
    to ``engine/sampling.py``'s: fresh (pose (A, N, 3), goal (A, N, 2)),
    views of one new buffer, from the uniforms ``Env._draw`` makes (None
    where the world draws none) and ``cur_pose`` (A, N, 3), where the
    robots stand (zeros when None).  RANDOM_DISC: ``u_pose`` (3, A, N),
    ``u_goal`` (2, A, N, K); TABLES_THEN_CORRIDOR: ``u_jitter`` (A, N, 2)
    where the world jitters, and where it has corridor robots ``u_pose``
    (3, A, N, K) and ``u_goal`` (2, A, N, K).  A FIXED_TABLES world never
    samples inside a step and has no kernel sample."""
    c, dev = w.consts, w.wall.device
    a, n = arenas, c.n
    _require(not w.fixed, lambda: "a FIXED_TABLES world samples no resets")
    disc = c.mode == ResetMode.RANDOM_DISC.value
    k = 1 if u_goal is None else u_goal.shape[-1]
    candidates = (((3, a, n) if disc else (3, a, n, k)), (2, a, n, k))
    want = (*(candidates if disc or c.n_fixed < n else (None, None)),
            (a, n, 2) if c.jitter > 0.0 else None,
            None if cur_pose is None else (a, n, 3))
    inputs = (u_pose, u_goal, u_jitter, cur_pose)
    got = tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                for t in inputs)
    _require(a > 0 and k > 0 and got == tuple(
        None if s is None else (s, _F32, dev) for s in want),
        lambda: f"uniforms {got}, not {want} float32 on {dev}")
    inputs = [None if t is None else t.contiguous() for t in inputs]
    m = a * n
    out = torch.empty(5 * m, dtype=_F32, device=dev)
    status = _launcher("env_sample_launch")(
        ctypes.addressof(c), a, k,
        *(None if t is None else t.data_ptr() for t in inputs),
        out.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "env_sample")
    graphs.launched(_count, "env_sample", m)
    return out[:3 * m].view(a, n, 3), out[3 * m:].view(a, n, 2)
