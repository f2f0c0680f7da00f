"""The batched collision-avoidance environment: A arenas x N robots per step.

Counterpart of ``rl_collision_avoidance_tpu/engine/env.py`` for the
``RANDOM_DISC`` reset mode and the disc footprint (the stage-1 curriculum).
One step, as in the JAX package and the reference (``stage_world1.py``):

1. clip the action to v in [0, 1], w in [-1, 1];
2. diff-drive integration; a robot whose candidate pose overlaps a wall or
   another robot keeps its previous pose (stall = crash);
3. reward and termination (goal +15, crash -15, progress x 2.5, spin
   penalty on the realized w, timeout);
4. robots whose episode ended get a fresh pose and goal inside the step;
5. one lidar pass at the post-reset poses, pushed into the 3-frame history
   (a fresh robot's history is filled with its first frame).

The lidar runs through ``ops/lidar_cuda.py::lidar_obs``: the hand-written
kernel when the env lives on the CUDA card, its plain version on the CPU.
``use_kernels=False`` runs the plain versions on any device, as the
reference the kernel path is held against.  Random draws come from the
env's own ``torch.Generator``; ``reset`` and ``step`` also take an injected
sample, so tests can feed both packages the same draws.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import lidar_cuda   # a module: ops/lidar_cuda.py imports this package
from ..utils.device import resolve_device
from ..worlds.spec import ResetMode, WorldSpec
from . import physics, sampling
from .celltable import build_cell_table, lookup_cells
from .lidar import beam_directions_local

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
    # alive at the step's start.  No robot of a RANDOM_DISC world ever dies,
    # so it is all True here; stage 2's dead robots will clear it.
    valid: torch.Tensor
    ep_return: torch.Tensor  # (A, N) episode return where an episode ended
    reached: torch.Tensor    # (A, N) bool reached-goal event
    crashed: torch.Tensor    # (A, N) bool crash event


def local_goal(pose: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
    """Goal in the body frame (stage_world1.py:155-160)."""
    dx = goal[..., 0] - pose[..., 0]
    dy = goal[..., 1] - pose[..., 1]
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    return torch.stack([dx * c + dy * s, -dx * s + dy * c], dim=-1)


class Env:
    """Batched stage-1 env for one :class:`WorldSpec` on one device (the
    CUDA card unless ``device`` says otherwise)."""

    def __init__(self, spec: WorldSpec, device=None, seed: int = 0,
                 use_kernels: bool = True):
        if (spec.reset_mode is not ResetMode.RANDOM_DISC
                or spec.footprint != "disc"):
            raise NotImplementedError(
                "the port runs RANDOM_DISC worlds with the disc footprint")
        self.spec = spec
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.n_robots = spec.n_robots
        self.frames = spec.laser_frames
        as_tensor = lambda a: torch.as_tensor(a, device=self.device)
        # The lidar table pads K to a multiple of 8 as the JAX package's
        # kernel path does; the wall table only needs candidates within
        # the robot radius, so K drops from 16 to 4 at stage 1.
        self.lidar_table = build_cell_table(spec.seg_p, spec.seg_e,
                                            spec.seg_valid, spec.max_range,
                                            cell=1.0, pad_multiple=8)
        self.wall_table = build_cell_table(spec.seg_p, spec.seg_e,
                                           spec.seg_valid, spec.robot_radius,
                                           cell=1.0, pad_multiple=2)
        self._lidar_cells = as_tensor(self.lidar_table.table)
        self._wall_cells = as_tensor(self.wall_table.table)
        self.local_dirs = as_tensor(beam_directions_local(spec.n_beams,
                                                          spec.fov))
        self._scan = (lidar_cuda.lidar_obs if use_kernels
                      else lidar_cuda.lidar_obs_plain)

    # ------------------------------------------------------------------

    def scan_obs(self, pose: torch.Tensor) -> torch.Tensor:
        """(A, N, 3) poses -> (A, N, B) normalized frame, range / max_range
        - 0.5."""
        t = self.lidar_table
        return self._scan(pose.contiguous(), self._lidar_cells, t.lo, t.cell,
                          t.shape, self.local_dirs, self.spec.robot_radius,
                          self.spec.max_range)

    def obs(self, state: EnvState) -> Obs:
        return Obs(scans=state.scan_hist, goal=local_goal(state.pose,
                                                          state.goal),
                   speed=state.speed)

    def sample_pose_goal(self, n_arenas: int):
        """Fresh (pose (A, N, 3), goal (A, N, 2)) for every robot."""
        spec = self.spec
        pose = sampling.stage1_poses((n_arenas, self.n_robots),
                                     spec.spawn_radius, self.generator,
                                     self.device)
        goal = sampling.stage1_goals(pose[..., :2], spec.spawn_radius,
                                     spec.goal_dist_min, spec.goal_dist_max,
                                     self.generator)
        return pose, goal

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
            dist=torch.linalg.vector_norm(goal - pose[..., :2], dim=-1),
            step=torch.zeros_like(z, dtype=torch.int32),
            scan_hist=first[:, :, None, :].repeat(1, 1, self.frames, 1),
            ep_return=z)
        return state, self.obs(state)

    def step(self, state: EnvState, action: torch.Tensor,
             reset_pose: torch.Tensor | None = None,
             reset_goal: torch.Tensor | None = None):
        """One control step of all robots of all arenas.

        action (A, N, 2) raw policy samples, clipped here.  ``reset_pose`` /
        ``reset_goal``: the fresh (pose, goal) sample for robots whose
        episode ends (drawn from the env's generator when not given).
        Returns (state', obs', reward, done, info).
        """
        spec = self.spec
        v = action[..., 0].clamp(V_MIN, V_MAX)
        w = action[..., 1].clamp(W_MIN, W_MAX)

        cand = physics.integrate(state.pose, v, w, spec.dt, spec.substeps)
        t = self.wall_table
        cells = lookup_cells(t.lo, t.cell, t.shape, cand[..., :2])
        wall = physics.wall_collision_packed(cand[..., :2],
                                             self._wall_cells[cells],
                                             spec.robot_radius)
        stalled = wall | physics.robot_collision(cand[..., :2],
                                                 spec.robot_radius)
        pose = torch.where(stalled[..., None], state.pose, cand)

        steps = state.step + 1
        dist_new = torch.linalg.vector_norm(state.goal - pose[..., :2], dim=-1)

        # Reward (stage_world1.py:180-211).  The spin penalty reads the
        # realized w: a stalled robot did not turn.
        reached = dist_new < spec.goal_size
        crashed = stalled
        timeout = steps > spec.timeout
        reward_g = torch.where(reached, 15.0, (state.dist - dist_new) * 2.5)
        reward_c = torch.where(crashed, -15.0, 0.0)
        w_real = w * ~stalled
        reward_w = torch.where(w_real.abs() > spec.omega_thresh,
                               -0.1 * w_real.abs(), 0.0)
        reward = reward_g + reward_c + reward_w

        terminal = reached | crashed | timeout
        result = torch.where(
            timeout, RESULT_TIMEOUT,
            torch.where(crashed, RESULT_CRASH,
                        torch.where(reached, RESULT_GOAL, RESULT_RUNNING)))

        if (reset_pose is None) != (reset_goal is None):
            raise ValueError("pass both reset_pose and reset_goal, or neither")
        if reset_pose is None:
            reset_pose, reset_goal = self.sample_pose_goal(pose.shape[0])
        m = terminal[..., None]
        pose = torch.where(m, reset_pose, pose)
        goal = torch.where(m, reset_goal, state.goal)
        dist = torch.where(
            terminal, torch.linalg.vector_norm(goal - pose[..., :2], dim=-1),
            dist_new)
        # Speed obs: the applied (v, w); fresh resets start at rest.
        speed = torch.where(m, 0.0, torch.stack([v, w], dim=-1))
        ep_return_now = state.ep_return + reward

        scan = self.scan_obs(pose)[:, :, None, :]
        shifted = torch.cat([state.scan_hist[:, :, 1:], scan], dim=2)
        scan_hist = torch.where(terminal[..., None, None], scan, shifted)

        new_state = EnvState(
            pose=pose, speed=speed, goal=goal, dist=dist,
            step=torch.where(terminal, 0, steps).to(torch.int32),
            scan_hist=scan_hist,
            ep_return=torch.where(terminal, 0.0, ep_return_now))
        info = StepInfo(result=result, valid=torch.ones_like(terminal),
                        ep_return=torch.where(terminal, ep_return_now, 0.0),
                        reached=reached, crashed=crashed)
        return new_state, self.obs(new_state), reward, terminal, info
