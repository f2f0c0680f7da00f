"""The port's GAE and clipped PPO (algo/) against the JAX package's on the
same inputs: rollouts and batches made from a seed with numpy, the JAX
params copied through jax_params_to_torch, and JAX's minibatch permutations
injected into the port's ppo_update.  Also the behaviour tests of
tests/test_gae_ppo.py, run on the port."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_collision_avoidance_tpu.algo import gae as jgae
from rl_collision_avoidance_tpu.algo import ppo as jppo
from rl_collision_avoidance_tpu.models import CNNPolicy as JCNNPolicy

from rl_collision_avoidance_torch.algo import (Batch, PPOConfig,
                                               calculate_returns,
                                               generate_train_data,
                                               normalize_advantages, ppo_loss,
                                               ppo_update)
from rl_collision_avoidance_torch.models import CNNPolicy
from rl_collision_avoidance_torch.utils.params import jax_params_to_torch
from torch_parity import assert_update_matches_jax

BEAMS = 64
# Float32 sums in another order than XLA's: the loss and its parts to 1e-5
# relative, each gradient leaf to 1e-5 of its largest value.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5


def test_gae_returns_and_normalization_match_jax():
    """(T = 16, E = 24) with episode cuts; 1e-6 absolute, the size of a few
    float32 roundings of these O(1)-O(10) sums."""
    rng = np.random.default_rng(0)
    t, e = 16, 24
    rewards = rng.standard_normal((t, e)).astype(np.float32)
    values = rng.standard_normal((t, e)).astype(np.float32)
    last = rng.standard_normal(e).astype(np.float32)
    dones = (rng.random((t, e)) < 0.15).astype(np.float32)
    assert dones.sum() > 10
    jt, ja = jgae.generate_train_data(rewards, values, last, dones, 0.99,
                                      0.95)
    mt, ma = generate_train_data(*map(torch.from_numpy,
                                      (rewards, values, last, dones)),
                                 0.99, 0.95)
    np.testing.assert_allclose(mt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ma.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    jr = jgae.calculate_returns(rewards, dones, last, gamma=0.99)
    mr = calculate_returns(*map(torch.from_numpy, (rewards, dones, last)),
                           gamma=0.99)
    np.testing.assert_allclose(mr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(normalize_advantages(ma).numpy(),
                               np.asarray(jppo.normalize_advantages(ja)),
                               rtol=0, atol=1e-6)


def _numpy_batch(m, seed=0, weight=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(scans=0.3 * f(m, 3, BEAMS), goal=f(m, 2), speed=f(m, 2),
                action=f(m, 2), logprob=f(m, 1) - 2.0, target=f(m, 1),
                adv=f(m, 1), weight=(np.ones(m, np.float32) if weight is None
                                     else weight))


def _both(arrays):
    return (jppo.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


@pytest.fixture(scope="module")
def nets():
    model = JCNNPolicy()
    params = model.init(jax.random.PRNGKey(7), jnp.zeros((1, 3, BEAMS)),
                        jnp.zeros((1, 2)), jnp.zeros((1, 2)))
    return model, params


def _policy(params):
    policy = CNNPolicy(beams=BEAMS)
    policy.load_state_dict(jax_params_to_torch(jax.device_get(params)))
    return policy


def test_ppo_loss_and_grads_match_jax(nets):
    model, params = nets
    w = np.ones(48, np.float32)
    w[5:12] = 0.0
    jb, mb = _both(_numpy_batch(48, seed=1, weight=w))
    cfg = PPOConfig()
    jloss = lambda p: jppo.ppo_loss(model.apply, p, jb, jppo.PPOConfig())
    (jl, jparts), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    policy = _policy(params)
    loss, parts = ppo_loss(policy, mb, cfg)
    names, ps = zip(*policy.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    for mine, ref in zip((loss, *parts), (jl, *jparts)):
        np.testing.assert_allclose(float(mine.detach()), float(ref),
                                   rtol=LOSS_RTOL)
    for name, ref in jax_params_to_torch(jax.device_get(jg)).items():
        scale = float(ref.abs().max()) + 1e-12
        np.testing.assert_allclose(grads[name].numpy(), ref.numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


def test_masked_loss_equals_filtered_loss(nets):
    """The weight mask stands for the reference's np.delete
    (model/ppo.py:212-218)."""
    policy = _policy(nets[1])
    w = np.ones(32, np.float32)
    w[10:20] = 0.0
    full = _numpy_batch(32)
    keep = np.r_[0:10, 20:32]
    _, masked = _both({**full, "weight": w})
    _, filtered = _both({k: v[keep] for k, v in full.items()})
    with torch.no_grad():
        lm, am = ppo_loss(policy, masked, PPOConfig())
        lf, af = ppo_loss(policy, filtered, PPOConfig())
    np.testing.assert_allclose(float(lm), float(lf), rtol=1e-5)
    for a, b in zip(am[:2], af[:2]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_ppo_loss_clipping(nets):
    """With adv > 0 and ratio >> 1 + clip, the clipped surrogate caps the
    objective at -(1 + clip)."""
    policy = _policy(nets[1])
    b = _numpy_batch(8)
    b.update(logprob=np.full((8, 1), -50.0, np.float32),
             adv=np.ones((8, 1), np.float32))
    with torch.no_grad():
        _, (pl, _, _) = ppo_loss(policy, _both(b)[1], PPOConfig(clip_value=0.1))
    np.testing.assert_allclose(float(pl), -1.1, rtol=1e-5)


def test_ppo_update_lowers_value_loss_and_moves_params(nets):
    policy = _policy(nets[1])
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    _, batch = _both(_numpy_batch(64))
    cfg = PPOConfig(batch_size=16, epochs=4, learning_rate=1e-3)
    opt = torch.optim.Adam(policy.parameters(), lr=cfg.learning_rate)
    with torch.no_grad():
        _, (_, vl_before, _) = ppo_loss(policy, batch, cfg)
    metrics = ppo_update(policy, opt, batch, cfg,
                         generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["policy_loss"]))
    assert np.isfinite(float(metrics["value_loss"]))
    assert max(float((policy.state_dict()[k] - v).abs().max())
               for k, v in before.items()) > 0
    with torch.no_grad():
        _, (_, vl_after, _) = ppo_loss(policy, batch, cfg)
    assert float(vl_after) < float(vl_before)


def test_ppo_update_warns_on_dropped_remainder(nets):
    policy = _policy(nets[1])
    opt = torch.optim.Adam(policy.parameters(), lr=1e-3)
    cfg = PPOConfig(batch_size=16, epochs=1)
    for m, warns in ((60, True), (64, False)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            ppo_update(policy, opt, _both(_numpy_batch(m))[1], cfg,
                       generator=torch.Generator().manual_seed(0))
        assert any("dropped" in str(w.message) for w in rec) == warns


def test_ppo_logstd_floor_projection(nets):
    """logstd_min projects logstd after every step; None leaves it free."""
    _, batch = _both(_numpy_batch(8))
    cfg = PPOConfig(batch_size=8, epochs=1, logstd_min=0.5)
    results = []
    for c in (cfg, cfg._replace(logstd_min=None)):
        policy = _policy(nets[1])
        opt = torch.optim.Adam(policy.parameters(), lr=c.learning_rate)
        ppo_update(policy, opt, batch, c,
                   generator=torch.Generator().manual_seed(0))
        results.append(policy.logstd.detach().numpy())
    np.testing.assert_array_equal(results[0], 0.5)   # 0-init, clamped up
    assert np.all(results[1] < 0.5)


def test_ppo_update_matches_jax(nets):
    """Three minibatches of 32 over two epochs from the same params, batch
    and permutations, against JAX ppo_update with optax.adam: the losses of
    every minibatch to 1e-5 relative, and the change of every parameter
    (new - old) as ``torch_parity.assert_update_matches_jax`` says.  Adam's
    steps are ~lr in size whatever the gradient's, so holding the
    parameters themselves would prove nothing; the change is the update."""
    model, params = nets
    w = np.ones(100, np.float32)
    w[::7] = 0.0
    jb, mb = _both(_numpy_batch(100, seed=3, weight=w))
    cfg = PPOConfig(batch_size=32, epochs=2, learning_rate=1e-3)
    jcfg = jppo.PPOConfig(batch_size=32, epochs=2, learning_rate=1e-3)
    tx = optax.adam(jcfg.learning_rate)
    key = jax.random.PRNGKey(11)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # 100 % 32: 4 samples dropped
        jparams, _, jm = jppo.ppo_update(model.apply, params,
                                         tx.init(params), tx, jb, key, jcfg)
    perms = np.stack([np.asarray(jax.random.permutation(k, 100))[:96]
                      for k in jax.random.split(key, 2)])

    # JAX's per-minibatch losses: ppo_update's own minibatch step, unrolled
    grad_fn = jax.grad(lambda p, b: jppo.ppo_loss(model.apply, p, b, jcfg),
                       has_aux=True)
    p, opt, jmb = params, tx.init(params), []
    for idx in perms.reshape(-1, 32):
        g, aux = grad_fn(p, jax.tree_util.tree_map(lambda x: x[idx], jb))
        upd, opt = tx.update(g, opt, p)
        p = optax.apply_updates(p, upd)
        jmb.append(np.asarray(aux))
    np.testing.assert_allclose(np.mean(jmb, axis=0),
                               [jm[k] for k in ("policy_loss", "value_loss",
                                                "entropy")], rtol=LOSS_RTOL)

    policy = _policy(params)
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    opt = torch.optim.Adam(policy.parameters(), lr=cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = ppo_update(policy, opt, mb, cfg, perms=torch.from_numpy(perms))
    np.testing.assert_allclose(m["minibatches"].numpy(), np.stack(jmb),
                               rtol=LOSS_RTOL)
    for k in ("policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL)
    assert_update_matches_jax(before, policy.state_dict(), params, jparams)
