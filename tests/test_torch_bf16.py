"""The port's bf16 mixed precision against the JAX package's, on the CPU.

bf16 mode rounds every product operand to bf16 and sums the exact products
in float32; both packages round at the same points (the trunks as
``TrunkConfig(precision="default", out_dtype="bfloat16")``, the dense tail
as ``cnn_pallas_apply(dtype=bfloat16)``) but add in other orders.  So a
bf16 output is bit-equal in the two, or, where its float32 value lies
within the two float32 sums' difference of a bf16 rounding boundary, one
bf16 ulp apart (an ulp is at most ``ULP`` of the value); a flipped
intermediate moves what follows it by far less.  Each comparison below
holds the float32 rule it would hold in float32, except for rounding
flips, which it counts: each must lie within one ulp, and together at most
``FLIP_SHARE`` of the elements (the reading beside each test).  The port's
plain bf16 trunks are what the CPU runs; the kernels are held to them on
the card (``tests/test_torch_gpu.py``, by the gates of
``tests/card_gates.py``).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_collision_avoidance_tpu.algo import ppo as jppo
from rl_collision_avoidance_tpu.engine.env import Env as JEnv
from rl_collision_avoidance_tpu.models import CNNPolicy as JCNNPolicy
from rl_collision_avoidance_tpu.ops.trunk_pallas import (TrunkConfig,
                                                         cnn_pallas_apply,
                                                         fused_trunks,
                                                         stack_trunk_params)
from rl_collision_avoidance_tpu.worlds import mini as jmini

from card_gates import BWD_TOL, trunk_grads_limits
from rl_collision_avoidance_torch import bench, cli
from rl_collision_avoidance_torch.algo import Batch, PPOConfig, ppo_update
from rl_collision_avoidance_torch.engine.env import Env
from rl_collision_avoidance_torch.models import CNNPolicy
from rl_collision_avoidance_torch.ops import trunk_cuda
from rl_collision_avoidance_torch.train import TrainConfig, Trainer
from rl_collision_avoidance_torch.utils.params import jax_params_to_torch
from rl_collision_avoidance_torch.worlds import mini
from torch_parity import (BF16_ATOL as ATOL, DELTA_NORM, FLIP_SHARE, ULP,
                          assert_flips_within_ulp, jax_reset_draw,
                          to_torch_state)

B = 40                 # not a multiple of the Pallas tile of 16
DEFAULT = dict(tile_fwd=16, tile_bwd=16, precision="default", interpret=True)
BF16 = torch.bfloat16


def bf16_np(x):
    """A float array rounded to bf16, as float32."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    scans = rng.uniform(-0.5, 0.5, (B, 3, 512)).astype(np.float32)
    goal = rng.standard_normal((B, 2)).astype(np.float32)
    speed = rng.standard_normal((B, 2)).astype(np.float32)
    model = JCNNPolicy()
    params = model.init(jax.random.PRNGKey(0), scans[:1], goal[:1], speed[:1])
    policy = CNNPolicy(dtype=BF16)
    policy.load_state_dict(jax_params_to_torch(jax.device_get(params)))
    return model, params, policy, scans, goal, speed


def _trunk_grads_to_torch(stacked_grads, params):
    """The stacked trunk gradients of ``fused_trunks`` in the port's layout:
    through a params tree that is zero outside the trunks."""
    tree = jax.tree_util.tree_map(np.zeros_like, jax.device_get(params))
    tree = jax.tree_util.tree_map(lambda x: x, tree)      # a mutable copy
    leaves = (("Conv_0", "kernel", "w1"), ("Conv_0", "bias", "b1"),
              ("Conv_1", "kernel", "w2"), ("Conv_1", "bias", "b2"),
              ("Dense_0", "kernel", "wf"), ("Dense_0", "bias", "bf"))
    for i, trunk in enumerate(("act_trunk", "crt_trunk")):
        for layer, leaf, key in leaves:
            tree["params"][trunk][layer][leaf] = np.asarray(
                stacked_grads[key][i])
    return jax_params_to_torch(tree)


def test_plain_bf16_trunks_match_pallas_default(setup):
    """Features (2, B, 256) and the twelve trunk gradients of the port's
    plain bf16 trunks against the JAX package's fused Pallas trunks in
    bf16 mode (interpret), with a bf16 cotangent.  Read: 12 feature flips of
    20,480; gradients: see the limit below."""
    _, params, policy, scans, _, _ = setup
    cfg = TrunkConfig(out_dtype="bfloat16", **DEFAULT)
    stacked = stack_trunk_params(params["params"])
    ref, vjp = jax.vjp(lambda st: fused_trunks(st, scans, cfg), stacked)
    act, crt = policy.trunk_weights("act"), policy.trunk_weights("crt")
    x = torch.from_numpy(scans)
    with torch.no_grad():
        mine = trunk_cuda.twin_trunks(x, act, crt, "bf16")
    assert mine.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert_flips_within_ulp(mine.float().numpy(), np.asarray(ref, np.float32),
                            "features")

    g = np.random.default_rng(1).standard_normal((2, B, 256))
    g16 = jnp.asarray(g, jnp.bfloat16)
    (jgrads,) = vjp(g16)
    ref_g = _trunk_grads_to_torch(jgrads, params)
    gt = torch.from_numpy(np.asarray(g16, np.float32)).to(BF16)
    act, crt = [w.detach() for w in act], [w.detach() for w in crt]
    got = trunk_cuda.twin_trunks_grads(x, act, crt, gt, "bf16")
    # Each package's float32 gradient lies within BWD_TOL of an
    # element's |terms| sum (plus the fc1 ReLUs near zero) of the exact
    # bf16-mode gradient, so the two within twice that; a rounding that
    # falls the other way (g2, g3, an activation) moves the terms it enters
    # by one ulp of one factor: within ULP of the |terms| sum, counted.
    limits = trunk_grads_limits(x, act, crt, gt, "bf16")
    names = [f"{t}_{n}" for t in ("act", "crt") for n in
             ("fea_cv1.weight", "fea_cv1.bias", "fea_cv2.weight",
              "fea_cv2.bias", "fc1.weight", "fc1.bias")]
    for t in range(2):
        for name, mine_g, scale, near in zip(names[6 * t:6 * t + 6], got[t],
                                             *limits[t]):
            want = ref_g[name].numpy().astype(np.float64)
            diff = np.abs(mine_g.double().numpy() - want)
            tight = 2 * (BWD_TOL * scale + near).numpy()
            loose = tight + ULP * scale.numpy()
            assert (diff <= loose).all(), name
            assert (diff > tight).sum() <= FLIP_SHARE * diff.size, name


def test_f32_mode_on_bf16_scans_matches_pallas(setup):
    """The float32 mode takes bf16 scans (--obs-bf16 without --bf16), as
    tests/test_trunk_pallas.py:112 has the Pallas trunks do: exact float32
    on the bf16 values, 3e-6 as tests/test_torch_trunk.py."""
    _, params, policy, scans, _, _ = setup
    x16 = jnp.asarray(scans, jnp.bfloat16)
    cfg = TrunkConfig(tile_fwd=16, tile_bwd=16, precision="float32",
                      out_dtype="float32", interpret=True)
    ref = fused_trunks(stack_trunk_params(params["params"]), x16, cfg)
    xt = torch.from_numpy(np.asarray(x16, np.float32)).to(BF16)
    with torch.no_grad():
        mine = trunk_cuda.twin_trunks(xt, policy.trunk_weights("act"),
                                      policy.trunk_weights("crt"))
    assert mine.dtype == torch.float32
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=3e-6)


def test_bf16_policy_matches_pallas_apply_and_flax(setup):
    """CNNPolicy(dtype=bf16) against cnn_pallas_apply(dtype=bf16), the
    function it ports.  value and the tanh half of mean by the flip rule
    (read: bit-equal).  The sigmoid half: XLA evaluates a bf16 logistic in
    bf16 steps, torch's bf16 sigmoid rounds its float32 value once, so the
    two differ by up to two bf16 ulps (read: 28 of 40 samples, at most
    0.8%).  Against the flax CNNPolicy(dtype=bf16), which adds each bias in
    bf16 before the ReLU, at the bounds tests/test_trunk_pallas.py:72-82
    hold the Pallas bf16 mode to (value 5e-2, mean 2e-2).  logstd is the
    float32 parameter in all three."""
    model, params, policy, scans, goal, speed = setup
    with torch.no_grad():
        value, mean, logstd = policy(*map(torch.from_numpy,
                                          (scans, goal, speed)))
    assert value.dtype == mean.dtype == logstd.dtype == torch.float32
    ref = cnn_pallas_apply(params, scans, goal, speed, dtype=jnp.bfloat16,
                           **DEFAULT)
    assert_flips_within_ulp(value.numpy(), np.asarray(ref[0]), "value")
    assert_flips_within_ulp(mean[:, 1].numpy(), np.asarray(ref[1])[:, 1],
                            "tanh mean")
    sig = np.asarray(ref[1])[:, 0]
    assert (np.abs(mean[:, 0].numpy() - sig) <= 2 * ULP * sig).all()
    np.testing.assert_array_equal(logstd.detach().numpy(), np.asarray(ref[2]))
    flax = JCNNPolicy(dtype=jnp.bfloat16).apply(params, scans, goal, speed)
    np.testing.assert_allclose(value.numpy(), np.asarray(flax[0]), atol=5e-2)
    np.testing.assert_allclose(mean.numpy(), np.asarray(flax[1]), atol=2e-2)


def test_env_obs_bf16_matches_jax():
    """Env(obs_dtype=bf16) reset and four steps against the JAX
    Env(obs_dtype=bfloat16) from the same state, actions and reset draws
    (mini world).  The scans are stored and emitted as bf16, and each new
    frame is the port's float32 lidar frame rounded (the cast comes after
    the lidar), bit for bit.  Both packages round float32 ranges that agree
    within the lidar tolerance (torch_parity.ATOL), so each bf16 value lies
    within ATOL plus one bf16 ulp of JAX's.  Rewards, dones and poses as in
    float32 (tests/test_torch_env.py: ATOL)."""
    spec, jspec = mini(), jmini()
    arenas = 2
    jenv = JEnv(jspec, lidar_mode="xla", obs_dtype=jnp.bfloat16)
    env = Env(spec, device="cpu", obs_dtype=BF16)
    env32 = Env(spec, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(3), arenas)
    jstate, jobs = jax.jit(jenv.reset)(keys)
    pose0, goal0 = jax_reset_draw(jenv, keys, jnp.zeros((arenas,
                                                          spec.n_robots, 3)))
    state, obs = env.reset(arenas, pose0, goal0)

    def check(obs, jobs, pose):
        assert obs.scans.dtype == BF16 and jobs.scans.dtype == jnp.bfloat16
        mine = obs.scans.float().numpy()
        ref = np.asarray(jobs.scans, np.float32)
        assert (np.abs(mine - ref) <= ATOL + ULP * np.abs(ref)).all()
        frame = env32.scan_obs(pose).to(BF16).float().numpy()
        np.testing.assert_array_equal(mine[..., -1, :], frame)

    check(obs, jobs, pose0)
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(4)
    for _ in range(4):
        act = rng.uniform([-0.2, -1.3], [1.2, 1.3],
                          (arenas, spec.n_robots, 2)).astype(np.float32)
        rp, rg = jax_reset_draw(jenv, jstate.key, jstate.pose)
        state = to_torch_state(jstate)
        assert state.scan_hist.dtype == BF16
        jstate, jobs, jr, jd, _ = jstep(jstate, jnp.asarray(act))
        state, obs, r, d, _ = env.step(state, torch.from_numpy(act), rp, rg)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=ATOL)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(state.pose.numpy(),
                                   np.asarray(jstate.pose), atol=ATOL)
        check(obs, jobs, state.pose)


def test_bf16_ppo_update_matches_jax():
    """One bf16 ppo_update (mini beams, 3 minibatches of 32 over 2 epochs,
    bf16 scans) from the same params, batch and permutations, against JAX's
    ppo_update through cnn_pallas_apply(dtype=bf16), with parameters and
    Adam state float32: the mean losses to 1e-2 relative (bf16 outputs),
    and the parameter change against the float32 update's as below.  bf16
    gradients carry ~2^-8 of rounding in every sample's term, which Adam's
    per-element normalisation turns into visible steps wherever a gradient
    nearly cancels, so the float32 rule of tests/test_torch_ppo.py cannot
    hold between two bf16 updates: each is held to its distance from the
    float32 update instead, the port's against JAX's."""
    beams, m = 64, 100
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = np.ones(m, np.float32)
    w[::7] = 0.0
    arrays = dict(scans=bf16_np(0.3 * f(m, 3, beams)), goal=f(m, 2),
                  speed=f(m, 2), action=f(m, 2), logprob=f(m, 1) - 2.0,
                  target=f(m, 1), adv=f(m, 1), weight=w)
    jb = jppo.Batch(**{k: jnp.asarray(v, jnp.bfloat16 if k == "scans"
                                      else None) for k, v in arrays.items()})
    mb = Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    mb = mb._replace(scans=mb.scans.to(BF16))
    model = JCNNPolicy()
    params = model.init(jax.random.PRNGKey(7), jnp.zeros((1, 3, beams)),
                        jnp.zeros((1, 2)), jnp.zeros((1, 2)))
    apply = lambda p, *a: cnn_pallas_apply(p, *a, dtype=jnp.bfloat16,
                                           **DEFAULT)
    cfg = PPOConfig(batch_size=32, epochs=2, learning_rate=1e-3)
    jcfg = jppo.PPOConfig(batch_size=32, epochs=2, learning_rate=1e-3)
    tx = optax.adam(jcfg.learning_rate)
    key = jax.random.PRNGKey(11)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # 100 % 32: 4 dropped
        jparams, _, jm = jppo.ppo_update(apply, params, tx.init(params), tx,
                                         jb, key, jcfg)
    perms = np.stack([np.asarray(jax.random.permutation(k, m))[:96]
                      for k in jax.random.split(key, 2)])

    policy = CNNPolicy(beams=beams, dtype=BF16)
    policy.load_state_dict(jax_params_to_torch(jax.device_get(params)))
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    opt = torch.optim.Adam(policy.parameters(), lr=cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metrics = ppo_update(policy, opt, mb, cfg,
                             perms=torch.from_numpy(perms))
    for k in ("policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-2, atol=1e-6, err_msg=k)
    after = policy.state_dict()
    assert all(v.dtype == torch.float32 for v in after.values())
    assert all(v.dtype == torch.float32 for st in opt.state.values()
               for k, v in st.items() if k != "step")
    jdelta = jax_params_to_torch(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b),
        jax.device_get(jparams), jax.device_get(params)))
    # The float32 update (flax apply) on the same bf16-valued batch: the
    # reference both bf16 updates stray from, by 0.1% to 19% of a leaf's
    # change (read: JAX 0.03% to 18.7%, the port 0.01% to 18.9%; over all
    # parameters 20.0% and 20.7%).
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j32, _, _ = jppo.ppo_update(
            model.apply, params, tx.init(params), tx,
            jppo.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            key, jcfg)
    f32 = jax_params_to_torch(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b),
        jax.device_get(j32), jax.device_get(params)))
    norm = np.linalg.norm
    total = np.zeros(3)
    for name, ref in jdelta.items():
        delta = (after[name] - before[name]).numpy().ravel()
        ref, exact = ref.numpy().ravel(), f32[name].numpy().ravel()
        mine_err, jax_err = norm(delta - exact), norm(ref - exact)
        total += np.square([mine_err, jax_err, norm(delta - ref)])
        # No leaf strays from the float32 change by more than twice what
        # JAX's bf16 update does, plus torch_parity's float32 DELTA_NORM
        # (read: at most 1.4x, but 2.4x on the scalar actor1.bias, whose
        # 0.32% the DELTA_NORM term covers)
        assert mine_err <= 2 * jax_err + DELTA_NORM * norm(exact), name
    mine_err, jax_err, apart = np.sqrt(total)
    # Over all parameters: the port's bf16 update as far from the float32
    # one as JAX's within 25% (read: 4%), and the two bf16 updates closer
    # to each other than 0.6 of JAX's distance to float32 (read: 0.41):
    # they round at the same points, and differ by their sums' orders and
    # XLA's bf16 logistic (see the policy test above).
    assert mine_err <= 1.25 * jax_err
    assert apart <= 0.6 * jax_err


def test_bf16_trainer_update_on_mini():
    """One Trainer update with policy_dtype and obs_store_dtype bf16 (as
    tests/test_train.py:96 runs the JAX trainer's bf16 obs storage): a bf16
    env history and rollout buffer, float32 parameters and Adam state,
    finite losses, moved parameters."""
    cfg = TrainConfig(world="mini", n_arenas=2, horizon=4,
                      ppo=PPOConfig(batch_size=8, epochs=1),
                      policy_dtype=BF16, obs_store_dtype=BF16)
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state()
    assert state.env_state.scan_hist.dtype == BF16
    assert state.policy.dtype == BF16
    _, traj, _ = tr._rollout(state)
    assert traj["scans"].dtype == BF16
    assert traj["goal"].dtype == torch.float32
    before = [p.detach().clone() for p in state.policy.parameters()]
    state, metrics = tr.train_step(state)
    for k in ("policy_loss", "value_loss", "entropy", "reward_mean"):
        assert np.isfinite(metrics[k]), k
    assert all(p.dtype == torch.float32 for p in state.policy.parameters())
    assert max(float((p.detach() - q).abs().max()) for p, q in
               zip(state.policy.parameters(), before)) > 0
    restored = tr.load_state_dict(tr.state_dict(state))
    assert restored.env_state.scan_hist.dtype == BF16


@pytest.mark.parametrize("argv,policy_dtype,obs_dtype", [
    ([], torch.float32, None),
    (["--bf16"], BF16, None),
    (["--obs-bf16"], torch.float32, BF16),
    (["--bf16", "--obs-bf16"], BF16, BF16)])
def test_cli_and_bench_parse_precision(argv, policy_dtype, obs_dtype):
    """--bf16 and --obs-bf16 reach TrainConfig on every train command and
    the bench's dtypes; the bench's --f32 forces float32 (its default)."""
    for cmd, stage in cli.STAGES.items():
        args = cli.parser().parse_args([cmd, "--arenas", "2", *argv])
        cfg = cli.train_config(stage, args)
        assert (cfg.policy_dtype, cfg.obs_store_dtype) == (policy_dtype,
                                                           obs_dtype)
    assert bench.precision(bench.parser().parse_args(argv)) == (
        policy_dtype, obs_dtype)
    assert bench.precision(bench.parser().parse_args([*argv, "--f32"])) == (
        torch.float32, None)
