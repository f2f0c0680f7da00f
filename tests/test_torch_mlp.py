"""The port's MLPPolicy against the JAX package's (forward in float32 and
bf16, init, the params mapping both ways), and reference ``.pth`` loading
(utils/params.py::load_pth through models/policy.py::load_policy) against
the JAX package's torch_interop and apply."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.models import CNNPolicy as JCNNPolicy
from rl_collision_avoidance_tpu.models import MLPPolicy as JMLPPolicy
from rl_collision_avoidance_tpu.utils.checkpoint import load_params_npz
from rl_collision_avoidance_tpu.utils.torch_interop import (
    flax_params_to_torch_state_dict)

from rl_collision_avoidance_torch.models import CNNPolicy, MLPPolicy
from rl_collision_avoidance_torch.models import load_policy
from rl_collision_avoidance_torch.utils.params import (jax_params_to_torch,
                                                       load_jax_npz,
                                                       save_params_npz,
                                                       torch_to_jax_params)
from torch_parity import assert_flips_within_ulp

OBS = 1540            # 3 x 512 scan beams, goal and speed, flattened
B = 40
ATOL = 1e-5           # float32: the same sums in another order


def _obs(b=B, seed=0):
    return np.random.default_rng(seed).standard_normal((b, OBS)).astype(
        np.float32)


def _jax_mlp(dtype=jnp.float32):
    model = JMLPPolicy(dtype=dtype)
    return model, jax.device_get(model.init(jax.random.PRNGKey(4), _obs(1)))


def _port_mlp(params, dtype=torch.float32):
    policy = MLPPolicy(OBS, dtype=dtype)
    policy.load_state_dict(jax_params_to_torch(params))
    return policy


def test_mlp_forward_matches_flax():
    model, params = _jax_mlp()
    obs = _obs(seed=1)
    ref = model.apply(params, obs)
    with torch.no_grad():
        mine = _port_mlp(params)(torch.from_numpy(obs))
    for name, r, m in zip(("value", "mean", "logstd"), ref, mine):
        assert m.dtype == torch.float32 and m.shape == r.shape, name
        np.testing.assert_allclose(m.detach().numpy(), np.asarray(r),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_mlp_forward_bf16_matches_flax():
    """bf16 compute (float32 params) as the JAX MLPPolicy(dtype=bfloat16):
    value and mean come back float32, each within the float32 rule or one
    bf16 ulp, flips at most 1% (tests/test_torch_bf16.py's rule).  Read:
    0 flips in the value, 0 in the mean, of 40 and 80."""
    model, params = _jax_mlp(jnp.bfloat16)
    obs = _obs(seed=2)
    ref = model.apply(params, obs)
    with torch.no_grad():
        value, mean, logstd = _port_mlp(params, torch.bfloat16)(
            torch.from_numpy(obs))
    assert value.dtype == mean.dtype == logstd.dtype == torch.float32
    assert_flips_within_ulp(value.numpy(), np.asarray(ref[0]), "value")
    assert_flips_within_ulp(mean.numpy(), np.asarray(ref[1]), "mean")
    np.testing.assert_array_equal(logstd.detach().numpy(),
                                  np.asarray(ref[2]))


def test_mlp_init_bounds():
    """PyTorch's default init, U(+-1/sqrt(fan_in)), with the mu weight
    scaled to 0.1 / sqrt(128) and value_fc3 unscaled, as the JAX module
    (whose own init obeys the same bounds); logstd starts at 0."""
    torch.manual_seed(0)
    policy = MLPPolicy(OBS)
    _, params = _jax_mlp()
    ref = jax_params_to_torch(params)
    fan_in = {"act_fc1": OBS, "act_fc2": 64, "mu": 128, "value_fc1": OBS,
              "value_fc2": 64, "value_fc3": 128}
    for name, n in fan_in.items():
        scale = 0.1 if name == "mu" else 1.0
        for sd in (policy.state_dict(), ref):
            w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
            assert float(w.abs().max()) <= scale / np.sqrt(n), name
            assert float(w.abs().max()) > 0.9 * scale / np.sqrt(n), name
            assert float(b.abs().max()) <= 1 / np.sqrt(n), name
    assert policy.mu.weight.shape == (2, 128)
    assert policy.value_fc3.weight.shape == (1, 128)
    assert torch.equal(policy.logstd.detach(), torch.zeros(2))
    assert set(policy.state_dict()) == set(ref)


def test_mlp_params_round_trip(tmp_path):
    """JAX tree -> port -> JAX tree, bit for bit; and the port's npz loads
    into the JAX package's MLPPolicy tree (load_params_npz) and back."""
    _, params = _jax_mlp()
    sd = jax_params_to_torch(params)
    back = torch_to_jax_params(sd)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    ref, got = flat(params), flat(back)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    policy = _port_mlp(params)
    path = tmp_path / "mlp_params.npz"
    save_params_npz(path, torch_to_jax_params(policy.state_dict()))
    loaded = load_params_npz(str(path), params)
    for k, v in flat(loaded).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    again = jax_params_to_torch(load_jax_npz(path))
    for k, v in policy.state_dict().items():
        assert torch.equal(again[k], v), k


def _cnn_inputs(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (b, 3, 512)).astype(np.float32),
            rng.standard_normal((b, 2)).astype(np.float32),
            rng.standard_normal((b, 2)).astype(np.float32))


def test_reference_pth_loads(tmp_path):
    """A reference checkpoint, made as the JAX package's interop makes one
    (flax_params_to_torch_state_dict, then torch.save): load_policy reads
    it, and the policy's output is JAX's apply within 1e-5."""
    scans, goal, speed = _cnn_inputs(16, 5)
    model = JCNNPolicy()
    params = jax.device_get(model.init(jax.random.PRNGKey(9), scans[:1],
                                       goal[:1], speed[:1]))
    sd = {k: torch.tensor(v)
          for k, v in flax_params_to_torch_state_dict(params).items()}
    path = tmp_path / "stage2.pth"
    torch.save(sd, path)
    policy = load_policy(path, device="cpu")
    ref = model.apply(params, scans, goal, speed)
    with torch.no_grad():
        mine = policy(*map(torch.from_numpy, (scans, goal, speed)))
    for name, r, m in zip(("value", "mean", "logstd"), ref, mine):
        np.testing.assert_allclose(m.detach().numpy(), np.asarray(r),
                                   atol=1e-5, rtol=0, err_msg=name)
    for k, v in sd.items():
        assert torch.equal(policy.state_dict()[k], v), k


@pytest.mark.parametrize("broken", ["missing", "unexpected", "shape",
                                    "not a dict"])
def test_reference_pth_is_checked(tmp_path, broken):
    """A .pth whose keys or shapes are not CNNPolicy's is refused before
    loading, naming what is wrong."""
    sd = CNNPolicy().state_dict()
    if broken == "missing":
        del sd["critic.bias"]
    elif broken == "unexpected":
        sd["module.extra"] = torch.zeros(1)
    elif broken == "shape":
        sd = CNNPolicy(beams=64).state_dict()
    else:
        sd = [torch.zeros(1)]
    path = tmp_path / "bad.pth"
    torch.save(sd, path)
    word = {"missing": "critic.bias", "unexpected": "module.extra",
            "shape": "act_fc1.weight", "not a dict": "not a state dict"}
    with pytest.raises(ValueError, match=word[broken]):
        load_policy(path, device="cpu")
