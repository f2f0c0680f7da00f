"""The port's RunningMeanStd (utils/running_stats.py) against the JAX
package's and against a numpy oracle, over uneven chunks, at 1e-6
relative: float32 sums of the same terms in other orders."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.utils.running_stats import (
    RunningMeanStd as JRunningMeanStd)

from rl_collision_avoidance_torch.utils.running_stats import RunningMeanStd

RTOL = 1e-6
EPS = 1e-4
CHUNKS = (5, 17, 1, 64, 2)


def _chunks(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(3.0, 2.0, size=(n, *shape)) for n in CHUNKS]


def _oracle(chunks):
    """Moments of the data with the initial (mean 0, variance 1, count EPS)
    as a phantom sample of weight EPS, in float64: what any exact parallel
    merge of the chunks gives, whatever their split."""
    x = np.concatenate(chunks)
    n = len(x) + EPS
    mean = x.sum(0) / n
    var = (EPS * 1.0 + (x ** 2).sum(0)) / n - mean ** 2
    return mean, var, n


@pytest.mark.parametrize("shape", [(4,), (), (3, 2)])
def test_matches_jax_and_oracle(shape):
    chunks = _chunks(len(shape), shape)
    mine = RunningMeanStd.create(shape, EPS, device="cpu")
    ref = JRunningMeanStd.create(shape, EPS)
    for c in chunks:
        mine = mine.update(c)                 # arrays in, as JAX takes them
        ref = ref.update(jnp.asarray(c))
    for name in ("mean", "var", "count", "std"):
        got = getattr(mine, name)
        want_shape = () if name == "count" else shape
        assert got.dtype == torch.float32 and got.shape == want_shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref, name)),
                                   rtol=RTOL, err_msg=name)
    mean, var, count = _oracle(chunks)
    np.testing.assert_allclose(mine.mean.numpy(), mean, rtol=RTOL)
    np.testing.assert_allclose(mine.var.numpy(), var, rtol=RTOL)
    np.testing.assert_allclose(mine.std.numpy(), np.sqrt(var), rtol=RTOL)
    np.testing.assert_allclose(float(mine.count), count, rtol=RTOL)


def test_update_is_functional_and_takes_tensors():
    """update returns a new value and leaves the old one as it was; a
    tensor chunk gives what the same array gives."""
    chunks = _chunks(7, (4,))
    start = RunningMeanStd.create((4,), device="cpu")
    a = start.update(chunks[0])
    b = start.update(torch.tensor(chunks[0]))
    assert torch.equal(start.mean, torch.zeros(4))
    assert torch.equal(start.var, torch.ones(4))
    assert float(start.count) == pytest.approx(EPS)
    for name in ("mean", "var", "count"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
