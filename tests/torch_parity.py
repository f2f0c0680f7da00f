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
import optax
import torch

from rl_collision_avoidance_tpu.algo import gae as jgae
from rl_collision_avoidance_tpu.algo import ppo as jppo
from rl_collision_avoidance_tpu.engine import lidar as jlidar
from rl_collision_avoidance_tpu.engine import physics as jphysics
from rl_collision_avoidance_tpu.models import CNNPolicy as JCNNPolicy
from rl_collision_avoidance_tpu.models import distributions as jdist
from rl_collision_avoidance_tpu.utils.checkpoint import load_params_npz
from rl_collision_avoidance_tpu.worlds.spec import ResetMode as JResetMode

from card_gates import BF16_FLIP_SHARE as FLIP_SHARE
from card_gates import BF16_ULP as ULP
from rl_collision_avoidance_torch.engine.celltable import lookup_cells
from rl_collision_avoidance_torch.engine.env import EnvState

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


def check_scans(env, mine, ref, pose, prev=None, reset=None):
    """Scan histories (A, N, F, B): the newest frame is held to the lidar
    parity rule above; the older frames are the previous history ``prev``
    shifted by one, or the newest frame again for robots that were reset
    (all when ``prev`` is None)."""
    assert_frame_matches_jax(env, mine[..., -1, :], ref[..., -1, :], pose)
    older = np.repeat(mine[..., -1:, :], mine.shape[-2] - 1, axis=-2)
    if prev is not None:
        older = np.where(reset[..., None, None], older, prev[..., 1:, :])
    np.testing.assert_array_equal(mine[..., :-1, :], older)


# ---------------------------------------------------------------------------
# bf16 outputs (see tests/test_torch_bf16.py's module docstring)
# ---------------------------------------------------------------------------

# Float32 sums of the same terms in another order: features and outputs
# to 1e-5, the float32 tests' order (tests/test_torch_trunk.py reads 3e-6).
BF16_ATOL = BF16_RTOL = 1e-5


def assert_flips_within_ulp(mine, ref, what, atol=BF16_ATOL, rtol=BF16_RTOL):
    """``mine`` against ``ref`` (arrays): within atol + rtol |ref|, but for
    rounding flips, each within atol + ULP |ref|, at most FLIP_SHARE of
    them.  Returns the flips."""
    mine, ref = (np.asarray(x, np.float64) for x in (mine, ref))
    diff = np.abs(mine - ref)
    flips = int((diff > atol + rtol * np.abs(ref)).sum())
    worst = float((diff - atol - ULP * np.abs(ref)).max())
    assert worst <= 0, f"{what}: an element {worst:.3g} beyond one bf16 ulp"
    assert flips <= FLIP_SHARE * diff.size, (what, flips, diff.size)
    return flips


# ---------------------------------------------------------------------------
# env steps: the JAX state and reset draws on the port's side
# ---------------------------------------------------------------------------

STATE_FIELDS = ("pose", "speed", "goal", "dist", "step", "dead", "scan_hist",
                "ep_return")


def _to_torch(x) -> torch.Tensor:
    """A JAX array as a torch tensor of its dtype (bf16 through float32,
    which holds every bf16 value exactly)."""
    if x.dtype == jnp.bfloat16:
        return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
    return torch.tensor(np.asarray(x))


def to_torch_state(jstate) -> EnvState:
    return EnvState(**{f: _to_torch(getattr(jstate, f))
                       for f in STATE_FIELDS})


def jax_reset_draw(jenv, keys, cur_pose):
    """The (pose, goal) sample JAX's Env draws from ``keys`` (A,) for robots
    standing at ``cur_pose`` (as its reset and step do)."""
    k = jax.vmap(lambda key: jax.random.split(key, 2))(keys)[:, 1]
    pose, goal = jenv._sample_pose_goal(k, cur_pose)
    return torch.tensor(np.asarray(pose)), torch.tensor(np.asarray(goal))


def jax_step_draw(jenv, jstate, action):
    """The reset sample JAX's ``Env.step(jstate, action)`` draws inside: the
    corridor sampler keeps 7 m from the robots' poses after the move and
    the stall, so those are recomputed here with the JAX package's physics
    (its dense wall test, the same as its culled one)."""
    spec = jenv.spec
    live = ~jstate.dead
    v = jnp.clip(action[..., 0], 0.0, 1.0) * live
    w = jnp.clip(action[..., 1], -1.0, 1.0)
    if spec.reset_mode is not JResetMode.FIXED_TABLES:
        w = w * live
    cand = jphysics.integrate(jstate.pose, v, w, spec.dt, spec.substeps)
    wall = jax.vmap(lambda p: jphysics.wall_collision(
        p, spec.seg_p, spec.seg_e, spec.seg_valid, spec.robot_radius))(
            cand[..., :2])
    stalled = wall | jphysics.robot_collision(cand[..., :2],
                                              spec.robot_radius)
    pose = jnp.where(stalled[..., None], jstate.pose, cand)
    return jax_reset_draw(jenv, jstate.key, pose)


def assert_step_matches_jax(env, prev_hist, port, ref):
    """One step's (state', obs', reward, done, info) of the port (``port``)
    against the JAX package's (``ref``), from the same state, whose scan
    history was ``prev_hist``: floats within ATOL, integers and flags equal,
    the new lidar frame by the lidar parity rule."""
    state, obs, r, d, info = port
    jstate, jobs, jr, jd, jinfo = ref
    for f in ("pose", "speed", "goal", "dist", "ep_return"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)), atol=ATOL,
                                   err_msg=f)
    for f in ("step", "dead"):
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(jstate, f)),
                                      err_msg=f)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=ATOL)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    for f in ("result", "valid", "reached", "crashed"):
        np.testing.assert_array_equal(getattr(info, f).numpy(),
                                      np.asarray(getattr(jinfo, f)),
                                      err_msg=f)
    np.testing.assert_allclose(info.ep_return.numpy(),
                               np.asarray(jinfo.ep_return), atol=ATOL)
    np.testing.assert_allclose(obs.goal.numpy(), np.asarray(jobs.goal),
                               atol=ATOL)
    reset = d.numpy() & ~state.dead.numpy()   # robots that were reset
    check_scans(env, obs.scans.numpy(), np.asarray(jobs.scans),
                state.pose.numpy(), prev_hist, reset)


# A PPO update's parameter change (new - old) against JAX's.  Adam divides
# each gradient by its own running RMS, so an element whose gradient nearly
# cancels (|g| near its float32 rounding error) moves by a visible part of
# lr on rounding alone: in tests/test_torch_ppo.py at most 11 of 131,072
# elements of a leaf differ by more than 1e-4 of the leaf's largest change,
# the worst by 5e-3.  So each leaf is held twice: every element within
# DELTA_ATOL of the largest change, and the whole leaf within DELTA_NORM in
# relative 2-norm (measured: at most 7e-5).  A wrong gradient, sign or bias
# correction misses both by orders of magnitude.  A leaf whose JAX change is
# exactly zero (a saturated sigmoid head passes no gradient) must not move.
DELTA_ATOL = 2e-2
DELTA_NORM = 1e-3
# Over the 16 Adam steps of a 4-epoch update from trained weights, a single
# element can drift further: Adam moves an element whose minibatch gradient
# is near its float32 rounding error by up to lr |g| / (|g| + eps), so the
# sign the rounding gives that gradient decides a visible part of lr.  Tests
# of such updates may leave the ``outliers`` elements of a leaf farthest
# from JAX's out of both rules, and hold them within one Adam step, lr,
# instead; a leaf gives up at most one element in OUTLIER_SHARE, so leaves
# under OUTLIER_SHARE elements give up none.  The readings behind each use
# stand beside it.
OUTLIER_SHARE = 100


def assert_update_matches_jax(before: dict, after: dict, jax_before,
                              jax_after, outliers: int = 0,
                              lr: float = 0.0):
    """``before``/``after``: the port's state dicts around the update;
    ``jax_before``/``jax_after``: the JAX params trees around it;
    ``outliers`` and ``lr`` as said above."""
    from rl_collision_avoidance_torch.utils.params import jax_params_to_torch

    jdelta = jax_params_to_torch(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b),
        jax.device_get(jax_after), jax.device_get(jax_before)))
    assert set(jdelta) == set(after)
    for name, ref in jdelta.items():
        ref = ref.numpy().ravel()
        delta = (after[name] - before[name]).numpy().ravel()
        scale = float(np.abs(ref).max())
        if scale == 0:
            assert not delta.any(), name
            continue
        take = min(outliers, ref.size // OUTLIER_SHARE)
        if take > 0:
            worst = np.argsort(np.abs(delta - ref))[-take:]
            assert np.abs(delta - ref)[worst].max() <= lr, name
            keep = np.ones(ref.size, bool)
            keep[worst] = False
            delta, ref = delta[keep], ref[keep]
        np.testing.assert_allclose(delta, ref, rtol=0,
                                   atol=DELTA_ATOL * scale, err_msg=name)
        rel = np.linalg.norm(delta - ref) / np.linalg.norm(ref)
        assert rel <= DELTA_NORM, (name, rel)


# ---------------------------------------------------------------------------
# one training update against a JAX chain
# ---------------------------------------------------------------------------

# Metrics: float32 sums over the rollout in another order than XLA's, and
# lidar frames that differ by up to ~1e-5 between the packages at grazing
# beams feed the values and log-probs: 1e-4 relative.
METRIC_RTOL = 1e-4


def jax_params(path, beams=512):
    """(JAX CNNPolicy, its params from a save_params_npz file)."""
    model = JCNNPolicy()
    tmpl = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, beams)),
                      jnp.zeros((1, 2)), jnp.zeros((1, 2)))
    return model, load_params_npz(str(path), tmpl)


def jax_update(jenv, model, params, jstate, noise, key, cfg):
    """One update as the JAX package's train/trainer.py::_train_step does
    it, from its public pieces.  Returns (new params, metrics, the reset
    draws of every step)."""
    a, n = jstate.pose.shape[:2]
    e = a * n
    flat = lambda x: x.reshape(e, *x.shape[2:])

    @jax.jit
    def act(state, obs, noise):
        value, mean, logstd = model.apply(params, flat(obs.scans),
                                          flat(obs.goal), flat(obs.speed))
        raw = mean + jnp.exp(logstd) * noise
        logprob = jdist.log_normal_density(raw, mean, logstd)
        scaled = jnp.stack([jnp.clip(raw[:, 0], 0.0, 1.0),
                            jnp.clip(raw[:, 1], -1.0, 1.0)],
                           axis=-1).reshape(a, n, 2)
        out = jenv.step(state, scaled)
        return (value[:, 0], raw, logprob[:, 0], scaled) + out

    obs = jenv._obs(jstate)
    resets, traj = [], []
    for t in range(len(noise)):
        value, raw, logprob, scaled, jnext, obs_next, reward, done, info = \
            act(jstate, obs, noise[t])
        resets.append(jax_step_draw(jenv, jstate, scaled))
        traj.append((obs, raw, logprob, value, reward, done, info))
        jstate, obs = jnext, obs_next
    stack = lambda f: jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                             *[f(s) for s in traj])
    obs_t, raw_t, logprob_t, value_t, reward_t, done_t, info_t = (
        stack(lambda s, i=i: s[i]) for i in range(7))
    raw_t, logprob_t, value_t = (x.reshape(len(noise), a, n, *x.shape[2:])
                                 for x in (raw_t, logprob_t, value_t))
    last_value = model.apply(params, flat(obs.scans), flat(obs.goal),
                             flat(obs.speed))[0][:, 0]

    t = len(noise)
    flat_e = lambda x: x.reshape(t, e, *x.shape[3:])
    targets, advs = jgae.generate_train_data(
        flat_e(reward_t), flat_e(value_t), last_value,
        flat_e(done_t.astype(jnp.float32)), 0.99, 0.95)
    advs = jppo.normalize_advantages(advs)
    flat_m = lambda x: jnp.moveaxis(x, 0, 2).reshape(t * e, *x.shape[3:])
    flat_te = lambda x: x.T.reshape(t * e)
    batch = jppo.Batch(scans=flat_m(obs_t.scans), goal=flat_m(obs_t.goal),
                       speed=flat_m(obs_t.speed), action=flat_m(raw_t),
                       logprob=flat_m(logprob_t)[:, None],
                       target=flat_te(targets)[:, None],
                       adv=flat_te(advs)[:, None],
                       weight=flat_m(info_t.valid).astype(jnp.float32))
    tx = optax.adam(cfg.learning_rate)
    new_params, _, losses = jppo.ppo_update(model.apply, params,
                                            tx.init(params), tx, batch, key,
                                            cfg)
    # and the port's count of robot-steps waiting for a group, from the
    # same trajectory
    metrics = {**{k: float(v) for k, v in losses.items()},
               "waiting": float(jnp.sum(~info_t.valid)),
               "episodes": float(jnp.sum(done_t & info_t.valid)),
               "ep_return_sum": float(jnp.sum(info_t.ep_return)),
               "reached": float(jnp.sum(info_t.reached)),
               "crashed": float(jnp.sum(info_t.crashed)),
               "reward_mean": float(jnp.mean(reward_t)),
               "env_steps": t * e}
    return new_params, metrics, resets


def assert_one_update_matches_jax(cfg, jenv, model, params, steps, seed=2,
                                  outliers=0):
    """One update of the port's Trainer(``cfg``) on the CPU against
    :func:`jax_update` on ``jenv`` (the same world), from the JAX params
    ``params``, arenas reset from ``seed`` with in-episode step counters
    ``steps`` (A, N), and the same sampling noise, reset draws and
    minibatch orders; the parameter change held by
    :func:`assert_update_matches_jax` with ``outliers``.  Returns (port
    metrics, JAX metrics)."""
    from rl_collision_avoidance_torch.train import Trainer
    from rl_collision_avoidance_torch.utils.params import jax_params_to_torch

    arenas, horizon, p = cfg.n_arenas, cfg.horizon, cfg.ppo
    n = jenv.n_robots
    keys = jax.random.split(jax.random.PRNGKey(seed), arenas)
    jstate, _ = jenv.reset(keys)
    jstate = jstate.replace(step=jnp.asarray(steps))
    noise = np.random.default_rng(seed).standard_normal(
        (horizon, arenas * n, 2)).astype(np.float32)
    key = jax.random.PRNGKey(seed + 1)
    jcfg = jppo.PPOConfig(batch_size=p.batch_size, epochs=p.epochs,
                          clip_value=p.clip_value,
                          coeff_entropy=p.coeff_entropy,
                          value_coeff=p.value_coeff,
                          learning_rate=p.learning_rate,
                          logstd_min=p.logstd_min)
    jnew, jm, resets = jax_update(jenv, model, params, jstate, noise, key,
                                  jcfg)
    m = horizon * arenas * n
    perms = np.stack([np.asarray(jax.random.permutation(k, m))
                      for k in jax.random.split(key, p.epochs)])

    tr = Trainer(cfg, device="cpu")
    state = tr.init_state()
    state.policy.load_state_dict(jax_params_to_torch(jax.device_get(params)))
    env_state, _ = tr.env.reset(arenas, *jax_reset_draw(
        jenv, keys, jnp.zeros((arenas, n, 3))))
    env_state.step = torch.from_numpy(np.asarray(steps, np.int32))
    state.env_state = env_state
    before = {k: v.clone() for k, v in state.policy.state_dict().items()}
    state, metrics = tr.train_step(state, noise=torch.from_numpy(noise),
                                   resets=resets,
                                   perms=torch.from_numpy(perms))
    assert state.update == 1
    assert set(metrics) == set(jm)
    for k, want in jm.items():
        np.testing.assert_allclose(metrics[k], want, rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)
    assert_update_matches_jax(before, state.policy.state_dict(), params,
                              jnew, outliers, p.learning_rate)
    return metrics, jm
