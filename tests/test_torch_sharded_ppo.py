"""``ppo_update`` (algo/ppo.py) over torch.distributed gloo ranks on the
CPU, against the JAX package's ``ppo_update_sharded`` on a CPU mesh of as
many devices, from the same params, batch and per-shard minibatch orders:
in a one-rank group (also bit-equal to the update without a group), and
in two worker processes (tests/torch_dist_worker.py); and with one
minibatch covering the batch, two ranks against the one-process
``ppo_update``."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_collision_avoidance_tpu.algo import ppo as jppo
from rl_collision_avoidance_tpu.models import CNNPolicy as JCNNPolicy
from rl_collision_avoidance_tpu.parallel import DATA_AXIS, make_mesh

from rl_collision_avoidance_torch.algo.ppo import Batch, PPOConfig, ppo_update
from rl_collision_avoidance_torch.models import CNNPolicy
from rl_collision_avoidance_torch.parallel import setup_distributed, teardown
from rl_collision_avoidance_torch.utils.params import jax_params_to_torch
from torch_dist_worker import run_ranks
from torch_parity import METRIC_RTOL, assert_update_matches_jax

M, FRAMES, BEAMS = 64, 3, 64
# tests/test_sharding.py::test_sharded_ppo_matches_unsharded_on_full_batch
FULL_BATCH_ATOL = 2e-6


def _batch(seed=0) -> dict:
    """A rollout of M samples as numpy arrays (weights 0 or 1)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return {"scans": rng.uniform(-0.5, 0.5, (M, FRAMES, BEAMS)).astype(
                np.float32),
            "goal": f32(M, 2), "speed": f32(M, 2), "action": f32(M, 2),
            "logprob": f32(M, 1), "target": f32(M, 1), "adv": f32(M, 1),
            "weight": (rng.uniform(size=M) > 0.2).astype(np.float32)}


def _jax_params(seed=0):
    model = JCNNPolicy()
    return model, model.init(jax.random.PRNGKey(seed),
                             jnp.zeros((1, FRAMES, BEAMS)),
                             jnp.zeros((1, 2)), jnp.zeros((1, 2)))


def _policy(state_dict):
    policy = CNNPolicy(FRAMES, BEAMS)
    policy.load_state_dict(state_dict)
    return policy, torch.optim.Adam(policy.parameters(), lr=5e-5,
                                    betas=(0.9, 0.999), eps=1e-8)


def _jax_shard_perms(key, epochs: int, m_local: int, used: int, world: int):
    """The minibatch orders JAX's ppo_update_sharded draws on each shard:
    fold_in(key, shard), split over the epochs, a permutation of the
    shard's samples cut to the used ones."""
    return np.stack([
        np.stack([np.asarray(jax.random.permutation(k, m_local))[:used]
                  for k in jax.random.split(jax.random.fold_in(key, ax),
                                            epochs)])
        for ax in range(world)])


@pytest.mark.parametrize("batch_size,epochs", [(16, 2), (M, 1)],
                         ids=["4 minibatches x 2 epochs", "one minibatch"])
def test_one_rank_group_update_matches_jax(batch_size, epochs, tmp_path):
    """ppo_update in a one-rank gloo group, whose collectives really run,
    against JAX's ppo_update_sharded on a one-device mesh (torch_parity's
    rule, the losses within METRIC_RTOL), and bit for bit the update
    without a group: params, Adam state, per-minibatch losses, and the
    orders drawn from a generator."""
    model, params = _jax_params(2)
    arrays = _batch(3)
    jcfg = jppo.PPOConfig(batch_size=batch_size, epochs=epochs)
    tx = optax.adam(jcfg.learning_rate)
    key = jax.random.PRNGKey(4)
    jbatch = jppo.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jnew, _, jm = jppo.ppo_update_sharded(model.apply, params,
                                          tx.init(params), tx, jbatch, key,
                                          jcfg, make_mesh(1), DATA_AXIS)
    perms = torch.from_numpy(_jax_shard_perms(key, epochs, M, M, 1)[0])
    start = jax_params_to_torch(jax.device_get(params))
    batch = Batch(*(torch.from_numpy(v) for v in arrays.values()))
    cfg = PPOConfig(batch_size=batch_size, epochs=epochs)

    def run(**orders):
        policy, opt = _policy(start)
        out = ppo_update(policy, opt, batch, cfg, **orders)
        return policy.state_dict(), opt.state_dict()["state"], out

    alone = run(perms=perms), run(generator=torch.Generator().manual_seed(5))
    setup_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        grouped = (run(perms=perms),
                   run(generator=torch.Generator().manual_seed(5)))
    finally:
        teardown()
    for (pa, sa, oa), (pb, sb, ob) in zip(alone, grouped):
        assert all(torch.equal(v, pb[k]) for k, v in pa.items())
        assert all(torch.equal(v, sb[i][k]) for i, st in sa.items()
                   for k, v in st.items())
        assert torch.equal(oa["minibatches"], ob["minibatches"])
    got, _, out = grouped[0]
    assert_update_matches_jax(start, got, params, jnew)
    for k in ("policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(out[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)


def test_two_ranks_match_jax_sharded_update(tmp_path):
    """Two gloo ranks against JAX's ppo_update_sharded on a 2-device mesh:
    the same params, batch and per-shard orders; the update within
    torch_parity's rule, the losses within METRIC_RTOL, and the two ranks'
    params bit-equal."""
    model, params = _jax_params()
    arrays = _batch(1)
    cfg = jppo.PPOConfig(batch_size=32, epochs=2)
    tx = optax.adam(cfg.learning_rate)
    key = jax.random.PRNGKey(7)
    jbatch = jppo.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jnew, _, jm = jppo.ppo_update_sharded(model.apply, params,
                                          tx.init(params), tx, jbatch, key,
                                          cfg, make_mesh(2), DATA_AXIS)
    perms = _jax_shard_perms(key, cfg.epochs, M // 2, M // 2, 2)
    start = jax_params_to_torch(jax.device_get(params))
    outs = run_ranks("ppo", {
        "params": start, "perms": torch.from_numpy(perms),
        "batch": {k: torch.from_numpy(v) for k, v in arrays.items()},
        "ppo": {"batch_size": 32, "epochs": 2}}, tmp_path)
    a, b = (o["params"] for o in outs)
    assert all(torch.equal(v, b[k]) for k, v in a.items())
    assert_update_matches_jax(start, a, params, jnew)
    for k in ("policy_loss", "value_loss", "entropy"):
        assert outs[0]["metrics"] == outs[1]["metrics"]
        np.testing.assert_allclose(outs[0]["metrics"][k], float(jm[k]),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)


def test_two_ranks_one_minibatch_is_the_one_process_update(tmp_path):
    """One minibatch covering the batch: the order within it cannot
    matter, so the two-rank update is the one-process ppo_update up to
    float32 summation order (FULL_BATCH_ATOL, the JAX test's)."""
    torch.manual_seed(1)
    start = CNNPolicy(FRAMES, BEAMS).state_dict()
    arrays = _batch(2)
    batch = Batch(*(torch.from_numpy(v) for v in arrays.values()))
    ref, opt = _policy(start)
    ppo_update(ref, opt, batch, PPOConfig(batch_size=M, epochs=1),
               torch.arange(M)[None])
    outs = run_ranks("ppo", {
        "params": start, "perms": torch.arange(M // 2).repeat(2, 1, 1),
        "batch": {k: torch.from_numpy(v) for k, v in arrays.items()},
        "ppo": {"batch_size": M, "epochs": 1}}, tmp_path)
    a, b = (o["params"] for o in outs)
    assert all(torch.equal(v, b[k]) for k, v in a.items())
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(a[k], v, atol=FULL_BATCH_ATOL, rtol=0,
                                   msg=k)
