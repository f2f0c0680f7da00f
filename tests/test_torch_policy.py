"""Weights carried across from the JAX package, the port's CNNPolicy forward
against the flax apply, and the Gaussian head math."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.models import CNNPolicy as JCNNPolicy
from rl_collision_avoidance_tpu.models import distributions as jdist
from rl_collision_avoidance_tpu.utils.checkpoint import load_params_npz
from rl_collision_avoidance_tpu.utils.torch_interop import (
    flax_params_to_torch_state_dict)

from rl_collision_avoidance_torch.models import CNNPolicy, load_policy
from rl_collision_avoidance_torch.models import distributions
from rl_collision_avoidance_torch.utils.params import (jax_params_to_torch,
                                                       load_jax_npz)

STAGE1 = Path(__file__).resolve().parents[1] / "results" / "stage1_params.npz"
ATOL = 2e-5


def _inputs(b, beams=512, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (b, 3, beams)).astype(np.float32),
            rng.standard_normal((b, 2)).astype(np.float32),
            rng.standard_normal((b, 2)).astype(np.float32))


def _init(beams=512):
    scans, goal, speed = _inputs(1, beams)
    return JCNNPolicy(), JCNNPolicy().init(jax.random.PRNGKey(3), scans,
                                           goal, speed)


def test_state_dict_matches_jax_interop():
    """The port's own copy of the params mapping gives exactly what the JAX
    package's flax_params_to_torch_state_dict gives."""
    _, params = _init()
    mine = jax_params_to_torch(jax.device_get(params))
    ref = flax_params_to_torch_state_dict(jax.device_get(params))
    assert set(mine) == set(ref) == set(CNNPolicy().state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("beams", [512, 64])
def test_forward_matches_flax(beams):
    model, params = _init(beams)
    policy = CNNPolicy(beams=beams)
    policy.load_state_dict(jax_params_to_torch(jax.device_get(params)))
    scans, goal, speed = _inputs(8, beams, seed=1)
    ref = model.apply(params, scans, goal, speed)
    with torch.no_grad():
        mine = policy(*map(torch.from_numpy, (scans, goal, speed)))
    for r, m in zip(ref, mine):
        np.testing.assert_allclose(m.detach().numpy(), np.asarray(r),
                                   atol=ATOL)


def test_load_stage1_npz_round_trip():
    """The committed trained weights load with numpy alone, leaf for leaf as
    the JAX package restores them, and drive the same forward."""
    tree = load_jax_npz(STAGE1)
    model, template = _init()
    ref = load_params_npz(str(STAGE1), template)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat_ref) == 23
    for path, leaf in flat_ref:
        node = tree
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    policy = load_policy(STAGE1, device="cpu")
    scans, goal, speed = _inputs(16, seed=2)
    want = model.apply(ref, scans, goal, speed)
    with torch.no_grad():
        got = policy(*map(torch.from_numpy, (scans, goal, speed)))
    for r, m in zip(want, got):
        np.testing.assert_allclose(m.detach().numpy(), np.asarray(r),
                                   atol=ATOL)


def test_distributions_match_jax():
    rng = np.random.default_rng(4)
    mean = rng.standard_normal((6, 2)).astype(np.float32)
    logstd = rng.uniform(-1.5, 0.5, 2).astype(np.float32)
    noise = rng.standard_normal((6, 2)).astype(np.float32)
    t = torch.from_numpy
    x = distributions.sample(t(mean), t(logstd), noise=t(noise))
    np.testing.assert_allclose(x.numpy(),
                               mean + np.exp(logstd) * noise, rtol=1e-6)
    np.testing.assert_allclose(
        distributions.log_normal_density(x, t(mean), t(logstd)).numpy(),
        np.asarray(jdist.log_normal_density(jnp.asarray(x.numpy()), mean,
                                            logstd)), atol=1e-5)
    np.testing.assert_allclose(distributions.entropy(t(logstd)).numpy(),
                               np.asarray(jdist.entropy(logstd)), atol=1e-6)


def test_sample_draws_from_the_generator():
    mean, logstd = torch.zeros(20000, 2), torch.tensor([-1.0, 0.5])
    g = torch.Generator().manual_seed(0)
    a = distributions.sample(mean, logstd, generator=g)
    b = distributions.sample(mean, logstd,
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.std(0).numpy(), np.exp([-1.0, 0.5]),
                               rtol=0.03)
