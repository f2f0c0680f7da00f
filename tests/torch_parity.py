"""Float32 parity of lidar ranges between the port and the JAX package.

Ranges are compared on the normalized obs scale at ``ATOL``.  Some beams
are ill-conditioned in float32: a beam that meets a wall at a grazing angle,
or grazes another robot's disc, where b^2 - c nearly cancels under the
square root.  There, any two correct float32 evaluations can differ by more
than ``ATOL``: on stage1 poses the JAX package's own eager, jitted, dense
and interpret-kernel evaluations differ by up to 6.5e-5.  So every beam is
held to the float64 result of the JAX function, at ``ATOL`` plus the most
that float64 range moves when the inputs move by float32-sized amounts
(headings by ``TURN``, positions by ``SHIFT`` with signs alternating
between robots, the disc radius by ``RADIUS_EPS``, which changes b^2 - c as
much as rounding |c - o|^2 ~ 36 m^2 does).  A beam that moves by no more
than ``ATOL`` under those perturbations is well-conditioned, and there the
port must also be within ``ATOL`` of the JAX float32 result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from rl_collision_avoidance_tpu.engine import lidar as jlidar

from rl_collision_avoidance_torch.engine.celltable import lookup_cells

ATOL = 1e-5  # on normalized obs, as tests/test_pallas.py holds the TPU kernel
TURN = 2.0 ** -22        # rad
SHIFT = 2.0 ** -20       # m
RADIUS_EPS = 2.0 ** -15  # m


def f64_ranges(fn, pose, *args, radius):
    """JAX ``fn(pose, *args, radius)`` in float64, and the most any range
    moves under the input perturbations of the module docstring."""
    sign = np.where(np.arange(pose.shape[-2]) % 2 == 0, 1.0, -1.0)
    with jax.enable_x64(True):
        up = [jnp.asarray(a, jnp.float64) if np.asarray(a).dtype.kind == "f"
              else jnp.asarray(a) for a in args]
        run = lambda p, r=radius: np.asarray(
            fn(jnp.asarray(p, jnp.float64), *up, r))
        truth = run(pose)
        moved = [run(pose, radius + d) for d in (RADIUS_EPS, -RADIUS_EPS)]
        for axis, step in ((2, TURN), (0, SHIFT), (1, SHIFT)):
            for d in (step, -step):
                p = pose.astype(np.float64)
                p[..., axis] += d * sign
                moved.append(run(p))
    return truth, np.max([np.abs(m - truth) for m in moved], axis=0)


def assert_matches_jax(mine, ref, truth, spread, max_range):
    """``mine`` (port, f32) and ``ref`` (JAX, f32) ranges, with ``truth`` and
    ``spread`` from :func:`f64_ranges`; see the module docstring."""
    mine, ref, truth, spread = (np.asarray(x, np.float64) / max_range
                                for x in (mine, ref, truth, spread))
    bad = np.argwhere(np.abs(mine - truth) > ATOL + spread)
    assert not len(bad), (f"{len(bad)} beams off, first {bad[:5]}: port "
                          f"{mine[tuple(bad[0])]}, f64 {truth[tuple(bad[0])]}"
                          f", allowed {ATOL + spread[tuple(bad[0])]}")
    bad = np.argwhere((spread <= ATOL) & (np.abs(mine - ref) > ATOL))
    assert not len(bad), (f"{len(bad)} well-conditioned beams differ from "
                          f"JAX, first {bad[:5]}: port {mine[tuple(bad[0])]}"
                          f", JAX {ref[tuple(bad[0])]}")


def assert_frame_matches_jax(env, mine, ref, pose):
    """Normalized lidar frames (A, N, B) of the port's ``env`` (``mine``) and
    of the JAX env (``ref``) at the port's poses ``pose`` (A, N, 3)."""
    t = env.lidar_table
    culled = t.table[lookup_cells(t.lo, t.cell, t.shape,
                                  torch.from_numpy(pose[..., :2])).numpy()]
    m = env.spec.max_range
    assert_matches_jax((mine + 0.5) * m, (ref + 0.5) * m,
                       *f64_ranges(lambda *a: jlidar.raycast_culled(*a, m),
                                   pose, env.local_dirs.numpy(), culled,
                                   radius=env.spec.robot_radius), m)


# A PPO update's parameter change (new - old) against JAX's.  Adam divides
# each gradient by its own running RMS, so an element whose gradient nearly
# cancels (|g| near its float32 rounding error) moves by a visible part of
# lr on rounding alone: in tests/test_torch_ppo.py at most 11 of 131,072
# elements of a leaf differ by more than 1e-4 of the leaf's largest change,
# the worst by 5e-3.  So each leaf is held twice: every element within
# DELTA_ATOL of the largest change, and the whole leaf within DELTA_NORM in
# relative 2-norm (measured: at most 7e-5).  A wrong gradient, sign or bias
# correction misses both by orders of magnitude.
DELTA_ATOL = 2e-2
DELTA_NORM = 1e-3


def assert_update_matches_jax(before: dict, after: dict, jax_before,
                              jax_after):
    """``before``/``after``: the port's state dicts around the update;
    ``jax_before``/``jax_after``: the JAX params trees around it."""
    from rl_collision_avoidance_torch.utils.params import jax_params_to_torch

    jdelta = jax_params_to_torch(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b),
        jax.device_get(jax_after), jax.device_get(jax_before)))
    assert set(jdelta) == set(after)
    for name, ref in jdelta.items():
        ref = ref.numpy()
        delta = (after[name] - before[name]).numpy()
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        np.testing.assert_allclose(delta, ref, rtol=0,
                                   atol=DELTA_ATOL * scale, err_msg=name)
        rel = np.linalg.norm(delta - ref) / np.linalg.norm(ref)
        assert rel <= DELTA_NORM, (name, rel)
