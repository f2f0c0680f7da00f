"""The batched collision-avoidance environment: A arenas x N robots per step.

Counterpart of ``rl_collision_avoidance_tpu/engine/env.py``, for both
footprints and in all three reset modes of the curriculum.  One step, as in
the JAX package and the reference (``stage_world1.py``, ``stage_world2.py``,
``circle_world.py``):

1. dead robots (stage-2 ``liveflag``, finished circle robots) act with
   v = 0, and w = 0 except in the circle eval, where they keep steering;
   live robots apply the action clipped to v in [0, 1], w in [-1, 1];
2. diff-drive integration; a robot whose candidate pose overlaps a wall or
   another robot keeps its previous pose (stall = crash): discs of
   ``robot_radius``, or for ``footprint="rect"`` Stage's exact 0.44 x 0.38 m
   oriented boxes;
3. reward and termination of the live robots (goal +15, crash -15,
   progress x 2.5, spin penalty on the realized w, timeout);
4. episode resets inside the step: per robot (``RANDOM_DISC``), per
   scenario group once every member is done (``TABLES_THEN_CORRIDOR``; a
   finished robot waits dead until then), or never (``FIXED_TABLES``);
5. one lidar pass at the post-reset poses, pushed into the 3-frame history
   (a fresh robot's history is filled with its first frame).

On the CUDA card a disc world's step runs steps 1-4 and the observation's
body-frame goal in the hand-written kernels of ``ops/env_cuda.py`` (one
launch, or two with the reset sampler between them, whose maps are a third;
the rule is ``env_cuda.kernel_path``); the CPU, ``use_kernels=False`` and
rect worlds run the plain PyTorch chain, :meth:`Env._step_plain`, and the
plain maps of ``engine/sampling.py``, which the kernels are held to bit for
bit.

The lidar runs through ``ops/lidar_cuda.py::lidar_obs``: the hand-written
kernel when the env lives on the CUDA card, its plain version on the CPU.
With disc silhouettes it computes walls and discs in one launch.  With box
silhouettes (``rect_silhouette``, the default of rect worlds) or
``disc_cull_k`` < N it computes the walls alone, and the env adds the
other robots' silhouettes in plain PyTorch (``engine/lidar.py::
raycast_robots``: every box, or the k nearest boxes or discs).
``use_kernels=False`` runs the plain versions on any device, as the
reference the kernel path is held against.  ``obs_dtype`` is the dtype
the scan history is stored and emitted in (float32 by default;
``torch.bfloat16`` halves the largest state tensor, as the JAX env's
``obs_dtype``): the lidar and all the geometry stay float32, and each new
frame is cast after the lidar.  Random draws come from the
env's own ``torch.Generator``; ``reset`` and ``step`` also take an injected
sample, so tests can feed both packages the same draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# modules: ops/lidar_cuda.py imports this package
from ..ops import env_cuda, lidar_cuda
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..worlds.spec import ResetMode, WorldSpec
from . import physics, sampling
from .celltable import build_cell_table, lookup_cells
from .lidar import (beam_directions_local, raycast_robots, rotate_beams,
                    sparse_beam_index)

# Action bounds [[v_min, w_min], [v_max, w_max]] (ppo_stage1.py:170).
V_MIN, V_MAX = 0.0, 1.0
W_MIN, W_MAX = -1.0, 1.0

RESULT_RUNNING = 0
RESULT_GOAL = 1
RESULT_CRASH = 2
RESULT_TIMEOUT = 3


@dataclasses.dataclass
class EnvState:
    pose: torch.Tensor       # (A, N, 3) x, y, theta
    speed: torch.Tensor      # (A, N, 2) applied (v, w)
    goal: torch.Tensor       # (A, N, 2)
    dist: torch.Tensor       # (A, N) distance to goal (the next step's "pre")
    step: torch.Tensor       # (A, N) int32 in-episode step counter
    dead: torch.Tensor       # (A, N) bool terminal-but-not-reset (stage2/circle)
    scan_hist: torch.Tensor  # (A, N, F, B) normalized lidar frames, newest last
    ep_return: torch.Tensor  # (A, N) running episode reward


@dataclasses.dataclass
class Obs:
    scans: torch.Tensor  # (A, N, F, B)
    goal: torch.Tensor   # (A, N, 2) goal in the robot body frame
    speed: torch.Tensor  # (A, N, 2)


@dataclasses.dataclass
class StepInfo:
    result: torch.Tensor     # (A, N) int result code of this step
    # (A, N) bool: the transition is usable for training, i.e. the robot was
    # alive at the step's start.
    valid: torch.Tensor
    ep_return: torch.Tensor  # (A, N) episode return where an episode ended
    reached: torch.Tensor    # (A, N) bool reached-goal event of a live robot
    crashed: torch.Tensor    # (A, N) bool crash event of a live robot


def local_goal(pose: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
    """Goal in the body frame (stage_world1.py:155-160)."""
    dx = goal[..., 0] - pose[..., 0]
    dy = goal[..., 1] - pose[..., 1]
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    return torch.stack([dx * c + dy * s, -dx * s + dy * c], dim=-1)


class Env:
    """Batched env for one :class:`WorldSpec` on one device (the CUDA card
    unless ``device`` says otherwise).

    ``disc_cull_k``: opt-in approximate silhouette culling, as the JAX
    env's: each robot's beams test only its k nearest other robots (discs,
    or boxes with ``rect_silhouette``); exact while at most k robots are in
    sensor range, and None (the default) is the exact configuration.
    ``rect_silhouette``: ray-trace the other robots as their oriented
    0.44 x 0.38 m boxes instead of discs; defaults to the world's
    ``footprint == "rect"``."""

    def __init__(self, spec: WorldSpec, device=None, seed: int = 0,
                 use_kernels: bool = True, obs_dtype: torch.dtype | None = None,
                 disc_cull_k: int | None = None,
                 rect_silhouette: bool | None = None):
        if spec.footprint not in ("disc", "rect"):
            raise ValueError(f"unknown footprint {spec.footprint!r}")
        if disc_cull_k is not None and disc_cull_k < 1:
            raise ValueError(f"disc_cull_k = {disc_cull_k} must be >= 1")
        self.spec = spec
        self.device = resolve_device(device)
        self.obs_dtype = obs_dtype or torch.float32
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.n_robots = spec.n_robots
        self.frames = spec.laser_frames
        self.obs_beams = spec.obs_beams or spec.n_beams
        self.disc_cull_k = disc_cull_k
        if rect_silhouette is None:
            rect_silhouette = spec.footprint == "rect"
        self.rect_silhouette = bool(rect_silhouette)
        self._rect_dims = ((spec.rect_half_len, spec.rect_half_wid)
                           if self.rect_silhouette else None)
        # The lidar kernel computes walls and exact discs in one launch;
        # boxes or culled discs are added to its walls-only mode.
        self.walls_only = self.rect_silhouette or (
            disc_cull_k is not None and disc_cull_k < spec.n_robots)
        as_tensor = lambda a: torch.as_tensor(a, device=self.device)
        # The lidar table pads K to a multiple of 8 as the JAX package's
        # kernel path does; the wall table only needs candidates within
        # the footprint's reach, the robot radius or the box's
        # circumradius, so K drops from 16 to 4 at stage 1.
        reach = spec.robot_radius
        if spec.footprint == "rect":
            reach = max(reach, float(np.hypot(spec.rect_half_len,
                                              spec.rect_half_wid)))
        self.lidar_table = build_cell_table(spec.seg_p, spec.seg_e,
                                            spec.seg_valid, spec.max_range,
                                            cell=1.0, pad_multiple=8)
        self.wall_table = build_cell_table(spec.seg_p, spec.seg_e,
                                           spec.seg_valid, reach,
                                           cell=1.0, pad_multiple=2)
        self._lidar_cells = as_tensor(self.lidar_table.table)
        self._wall_cells = as_tensor(self.wall_table.table)
        self.local_dirs = as_tensor(beam_directions_local(spec.n_beams,
                                                          spec.fov))
        self._obs_idx = (None if self.obs_beams == spec.n_beams else
                         as_tensor(sparse_beam_index(spec.n_beams,
                                                     self.obs_beams)).long())
        self._scan = (lidar_cuda.lidar_obs if use_kernels
                      else lidar_cuda.lidar_obs_plain)
        self._kernels = (env_cuda.world(spec, self._wall_cells,
                                        self.wall_table)
                         if env_cuda.kernel_path(self.device, use_kernels,
                                                 spec.footprint) else None)
        # The reset sampler's kernel: the kernel path of a world that resets
        # (a FIXED_TABLES world samples only in reset, and plainly).
        self._sampler = (self._kernels if self._kernels is not None
                         and not self._kernels.fixed else None)
        if spec.reset_mode is not ResetMode.RANDOM_DISC:
            self._pose_table = as_tensor(spec.init_pose_table)
            self._goal_table = as_tensor(spec.goal_table)
            self._fixed = (torch.arange(self.n_robots, device=self.device)
                           < spec.n_fixed)
        if spec.group_id is not None:
            gid = torch.as_tensor(spec.group_id, dtype=torch.long)
            self._group_id = gid.to(self.device)
            self._group_member = (gid[None, :] == torch.arange(
                int(gid.max()) + 1)[:, None]).to(self.device)   # (G, N)

    # ------------------------------------------------------------------

    def scan_obs(self, pose: torch.Tensor) -> torch.Tensor:
        """(A, N, 3) poses -> (A, N, obs_beams) normalized frame, range /
        max_range - 0.5, after the optional sparse resample, in
        ``obs_dtype``."""
        t, spec = self.lidar_table, self.spec
        pose = pose.contiguous()
        scan = self._scan(pose, self._lidar_cells, t.lo, t.cell, t.shape,
                          self.local_dirs, spec.robot_radius, spec.max_range,
                          discs=not self.walls_only)
        if self.walls_only:
            # The kernel's normalized walls and the normalized silhouettes
            # combine by their minimum.  The normalize x -> fl(fl(x /
            # max_range) - 0.5) is monotone and a minimum commutes with a
            # monotone map, so this is the JAX package's min(d_seg, d_rob,
            # max_range) / max_range - 0.5 to the last bit.
            scan = torch.minimum(scan, self.silhouette_obs(pose))
        if self._obs_idx is not None:
            scan = scan[..., self._obs_idx]
        return scan.to(self.obs_dtype)

    def silhouette_obs(self, pose: torch.Tensor) -> torch.Tensor:
        """(A, N, 3) poses -> (A, N, B) the other robots' silhouettes alone
        (boxes or culled discs, plain PyTorch), normalized as
        ``lidar_cuda.lidar_obs_plain`` normalizes ranges."""
        m = self.spec.max_range
        dx, dy = rotate_beams(pose[..., 2], self.local_dirs)
        d_rob = raycast_robots(pose, dx, dy, self.spec.robot_radius,
                               self.disc_cull_k, self._rect_dims)
        return d_rob.clamp_max(m) / m - 0.5

    def obs(self, state: EnvState) -> Obs:
        return Obs(scans=state.scan_hist, goal=local_goal(state.pose,
                                                          state.goal),
                   speed=state.speed)

    def sample_pose_goal(self, n_arenas: int,
                         cur_pose: torch.Tensor | None = None):
        """Fresh (pose (A, N, 3), goal (A, N, 2)) for every robot; the env
        applies them under its reset mask.  ``cur_pose`` (A, N, 3), zeros
        when not given, is where the robots stand: a corridor pose lies at
        least 7 m from it.  The uniforms come from the env's generator
        (:meth:`_draw`); on the kernel path of a world that resets the
        card's sampler kernel maps them (``env_cuda.sample``), elsewhere
        the plain maps (:meth:`_sample_plain`), bit for bit alike."""
        draws = self._draw(n_arenas)
        if self._sampler is not None:
            return env_cuda.sample(self._sampler, n_arenas, *draws, cur_pose)
        return self._sample_plain(n_arenas, *draws, cur_pose)

    def _draw(self, a: int):
        """(u_pose, u_goal, u_jitter): the uniforms of one sample of ``a``
        arenas, drawn in this order: the disc's pose (3, A, N) and goal
        candidates (2, A, N, K); or the table jitter (A, N, 2) where the
        world jitters, then its corridor robots' pose (3, A, N, K) and goal
        (2, A, N, K) candidates where it has them.  None where the world
        draws none."""
        spec, n, k = self.spec, self.n_robots, sampling._K

        def rand(*shape):
            return torch.rand(shape, generator=self.generator,
                              device=self.device)

        if spec.reset_mode is ResetMode.RANDOM_DISC:
            u_pose = rand(3, a, n)
            return u_pose, rand(2, a, n, k), None
        u_jitter = rand(a, n, 2) if spec.pose_jitter > 0.0 else None
        if (spec.reset_mode is ResetMode.TABLES_THEN_CORRIDOR
                and spec.n_fixed < n):
            u_pose = rand(3, a, n, k)
            return u_pose, rand(2, a, n, k), u_jitter
        return None, None, u_jitter

    def _sample_plain(self, a: int, u_pose, u_goal, u_jitter,
                      cur_pose: torch.Tensor | None = None):
        """:meth:`sample_pose_goal` from the uniforms of :meth:`_draw`,
        through ``engine/sampling.py``'s plain maps."""
        spec, n = self.spec, self.n_robots
        if spec.reset_mode is ResetMode.RANDOM_DISC:
            pose = sampling.stage1_poses_from(u_pose, spec.spawn_radius)
            goal = sampling.stage1_goals_from(
                u_goal, pose[..., :2], spec.spawn_radius, spec.goal_dist_min,
                spec.goal_dist_max)
            return pose, goal
        # Table poses, optionally jittered (circle_train: uniform +-J on x/y
        # at every reset; goals and headings stay exact).
        pose = (self._pose_table.expand(a, n, 3).clone() if u_jitter is None
                else sampling.table_poses_from(u_jitter, self._pose_table,
                                               spec.pose_jitter))
        goal = self._goal_table.expand(a, n, 2)
        if u_pose is not None:
            if cur_pose is None:
                cur_pose = torch.zeros((a, n, 3), device=self.device)
            rpose = sampling.corridor_poses_from(u_pose, cur_pose[..., :2])
            rgoal = sampling.corridor_goals_from(u_goal, rpose[..., :2])
            fixed = self._fixed[:, None]
            pose = torch.where(fixed, pose, rpose)
            goal = torch.where(fixed, goal, rgoal)
        return pose, goal.clone()

    def _reset_dist(self, pose: torch.Tensor, goal: torch.Tensor):
        """The first "previous distance": the true one (stage 1,
        stage_world1.py:171-177) or 0 (stage 2 and circle,
        stage_world2.py:170)."""
        if self.spec.dist_prev_zero_on_reset:
            return torch.zeros_like(pose[..., 0])
        return torch.linalg.vector_norm(goal - pose[..., :2], dim=-1)

    def reset(self, n_arenas: int, pose: torch.Tensor | None = None,
              goal: torch.Tensor | None = None) -> tuple[EnvState, Obs]:
        """Fresh arenas, from the env's generator or the given sample."""
        if (pose is None) != (goal is None):
            raise ValueError("pass both pose and goal, or neither")
        if pose is None:
            pose, goal = self.sample_pose_goal(n_arenas)
        z = torch.zeros((n_arenas, self.n_robots), device=self.device)
        first = self.scan_obs(pose)
        state = EnvState(
            pose=pose, speed=torch.zeros_like(pose[..., :2]), goal=goal,
            dist=self._reset_dist(pose, goal),
            step=torch.zeros_like(z, dtype=torch.int32),
            dead=torch.zeros_like(z, dtype=torch.bool),
            scan_hist=first[:, :, None, :].repeat(1, 1, self.frames, 1),
            ep_return=z)
        return state, self.obs(state)

    def step(self, state: EnvState, action: torch.Tensor,
             reset_pose: torch.Tensor | None = None,
             reset_goal: torch.Tensor | None = None):
        """One control step of all robots of all arenas.

        action (A, N, 2) raw policy samples, clipped here.  ``reset_pose`` /
        ``reset_goal``: the fresh (pose, goal) sample of every robot, of
        which the env takes those it resets (drawn from the env's generator
        when not given; a ``FIXED_TABLES`` world never resets and ignores
        them).  Returns (state', obs', reward, done, info); ``done`` stays
        True while a robot is dead.  Traced as ``env_step``, with
        ``env_physics``, ``env_reset`` and ``env_lidar`` inside it, and
        ``env_sample`` (the env's own draw) inside ``env_reset``.
        """
        if (reset_pose is None) != (reset_goal is None):
            raise ValueError("pass both reset_pose and reset_goal, or "
                             "neither")
        with span("env_step"):
            if self._kernels is not None:
                return self._step_kernels(state, action, reset_pose,
                                          reset_goal)
            return self._step_plain(state, action, reset_pose, reset_goal)

    def _step_kernels(self, state: EnvState, action: torch.Tensor,
                      reset_pose, reset_goal):
        """:meth:`step` through ``ops/env_cuda.py``'s kernels."""
        kernels = self._kernels
        with span("env_physics"):
            out = env_cuda.physics(kernels, state, action)
        if not kernels.fixed:
            with span("env_reset"):
                if reset_pose is None:
                    with span("env_sample"):
                        reset_pose, reset_goal = self.sample_pose_goal(
                            out.pose.shape[0], out.phys_pose)
                env_cuda.reset_apply(kernels, out, reset_pose, reset_goal)
        with span("env_lidar"):
            scan = self.scan_obs(out.pose)[:, :, None, :]
            scan_hist = torch.cat([state.scan_hist[:, :, 1:], scan], dim=2)
            if not kernels.fixed:
                scan_hist = torch.where(out.reset[..., None, None], scan,
                                        scan_hist)
        new_state = EnvState(pose=out.pose, speed=out.speed, goal=out.goal,
                             dist=out.dist, step=out.step, dead=out.dead,
                             scan_hist=scan_hist, ep_return=out.ep_return)
        obs = Obs(scans=scan_hist, goal=out.obs_goal, speed=out.speed)
        info = StepInfo(result=out.result, valid=out.valid,
                        ep_return=out.info_return, reached=out.reached,
                        crashed=out.crashed)
        return new_state, obs, out.reward, out.done, info

    def _step_plain(self, state: EnvState, action: torch.Tensor,
                    reset_pose, reset_goal):
        """:meth:`step` as the plain PyTorch chain: the CPU's path, the
        rect footprint's, and the reference the kernels are held to."""
        spec = self.spec
        live = ~state.dead
        v = action[..., 0].clamp(V_MIN, V_MAX) * live
        w = action[..., 1].clamp(W_MIN, W_MAX)
        if spec.reset_mode is not ResetMode.FIXED_TABLES:
            # Finished circle-eval robots keep steering with the
            # policy's w but v := 0 (circle_test.py:64-66): they spin
            # in place.
            w = w * live

        with span("env_physics"):
            cand = physics.integrate(state.pose, v, w, spec.dt,
                                     spec.substeps)
            t = self.wall_table
            culled = self._wall_cells[lookup_cells(t.lo, t.cell, t.shape,
                                                   cand[..., :2])]
            if spec.footprint == "rect":
                hl, hw = spec.rect_half_len, spec.rect_half_wid
                stalled = (
                    physics.rect_wall_collision(cand, culled, hl, hw)
                    | physics.rect_robot_collision(cand, hl, hw))
            else:
                stalled = (
                    physics.wall_collision_packed(cand[..., :2], culled,
                                                  spec.robot_radius)
                    | physics.robot_collision(cand[..., :2],
                                              spec.robot_radius))
            pose = torch.where(stalled[..., None], state.pose, cand)

        steps = state.step + live.to(torch.int32)
        dist_new = torch.linalg.vector_norm(state.goal - pose[..., :2],
                                            dim=-1)

        # Reward (stage_world1.py:180-211).  The spin penalty reads the
        # realized w: a stalled robot did not turn.
        reached = dist_new < spec.goal_size
        crashed = stalled
        timeout = steps > spec.timeout
        reward_g = torch.where(reached, 15.0,
                               (state.dist - dist_new) * 2.5)
        reward_c = torch.where(crashed, -15.0, 0.0)
        w_real = w * ~stalled
        reward_w = torch.where(w_real.abs() > spec.omega_thresh,
                               -0.1 * w_real.abs(), 0.0)
        reward = (reward_g + reward_c + reward_w) * live

        terminal = (reached | crashed | timeout) & live
        result = torch.where(
            timeout, RESULT_TIMEOUT,
            torch.where(crashed, RESULT_CRASH,
                        torch.where(reached, RESULT_GOAL, RESULT_RUNNING)))
        result = torch.where(live, result, RESULT_RUNNING)

        dead_after = state.dead | terminal
        if spec.reset_mode is ResetMode.RANDOM_DISC:
            reset_mask = terminal
            dead_next = torch.zeros_like(dead_after)
        elif spec.reset_mode is ResetMode.TABLES_THEN_CORRIDOR:
            # Group-synchronized episode boundaries (model/utils.py:81-87).
            group_done = (dead_after[:, None, :]
                          | ~self._group_member).all(dim=-1)     # (A, G)
            reset_mask = group_done[:, self._group_id]            # (A, N)
            dead_next = dead_after & ~reset_mask
        else:                                   # FIXED_TABLES: never reset
            reset_mask = None
            dead_next = dead_after

        ep_return_now = state.ep_return + reward
        goal, dist, step_ctr = state.goal, dist_new, steps
        speed = torch.stack([v, w], dim=-1)
        ep_return = ep_return_now
        if reset_mask is not None:
            with span("env_reset"):
                if reset_pose is None:
                    with span("env_sample"):
                        reset_pose, reset_goal = self.sample_pose_goal(
                            pose.shape[0], pose)
                m = reset_mask[..., None]
                pose = torch.where(m, reset_pose, pose)
                goal = torch.where(m, reset_goal, goal)
                dist = torch.where(reset_mask,
                                   self._reset_dist(pose, goal), dist)
                step_ctr = torch.where(reset_mask, 0, step_ctr)
                # Speed obs: the applied (v, w); fresh resets start at
                # rest.
                speed = torch.where(m, 0.0, speed)
                ep_return = torch.where(reset_mask, 0.0, ep_return)

        with span("env_lidar"):
            scan = self.scan_obs(pose)[:, :, None, :]
            scan_hist = torch.cat([state.scan_hist[:, :, 1:], scan],
                                  dim=2)
            if reset_mask is not None:
                scan_hist = torch.where(reset_mask[..., None, None], scan,
                                        scan_hist)

        new_state = EnvState(
            pose=pose, speed=speed, goal=goal, dist=dist,
            step=step_ctr.to(torch.int32), dead=dead_next,
            scan_hist=scan_hist, ep_return=ep_return)
        done = state.dead | terminal
        info = StepInfo(result=result, valid=live,
                        ep_return=torch.where(terminal, ep_return_now,
                                              0.0),
                        reached=reached & live, crashed=crashed & live)
        return new_state, self.obs(new_state), reward, done, info

    def teleport(self, state: EnvState, pose: torch.Tensor,
                 mask: torch.Tensor | None = None) -> EnvState:
        """Set robot poses directly, the reference's ``control_pose``
        (stage_world1.py:237-249).  pose (A, N, 3); mask an optional (A, N)
        bool selecting robots.  The goal distance is re-derived; the lidar
        history refreshes on the next step."""
        if mask is not None:
            pose = torch.where(mask[..., None], pose, state.pose)
        dist = torch.linalg.vector_norm(state.goal - pose[..., :2], dim=-1)
        return dataclasses.replace(state, pose=pose, dist=dist)

    # single-arena conveniences (tests, simple scripts)

    def reset1(self, pose: torch.Tensor | None = None,
               goal: torch.Tensor | None = None) -> tuple[EnvState, Obs]:
        """:meth:`reset` of one arena, the arena axis dropped from the state
        and obs; ``pose`` (N, 3) and ``goal`` (N, 2) an optional sample."""
        state, obs = self.reset(1, _arena(pose), _arena(goal))
        return _unarena(state), _unarena(obs)

    def step1(self, state: EnvState, action: torch.Tensor,
              reset_pose: torch.Tensor | None = None,
              reset_goal: torch.Tensor | None = None):
        """:meth:`step` of one arena's state without the arena axis: action
        (N, 2), optional reset sample (N, 3) and (N, 2); returns (state',
        obs', reward, done, info), each without the arena axis."""
        out = self.step(_arena(state), action[None], _arena(reset_pose),
                        _arena(reset_goal))
        return tuple(_unarena(o) for o in out)


def _map_tensors(x, fn):
    """``fn`` on a tensor, or on every field of a state/obs/info record."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: fn(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return fn(x)


def _arena(x):
    """A leading arena axis of 1 on ``x`` (None stays None)."""
    return None if x is None else _map_tensors(x, lambda t: t[None])


def _unarena(x):
    return _map_tensors(x, lambda t: t[0])
