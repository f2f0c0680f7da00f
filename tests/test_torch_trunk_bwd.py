"""The port's twin-trunk backward (ops/trunk_cuda.py: TwinTrunks and
twin_trunks_grads, plain version on the CPU) against jax.grad of the JAX
package's fused Pallas trunks (exact float32, interpret mode) and of the
flax CNNPolicy apply.  B = 37 on the mini beam count is ragged against the
Pallas tile of 16.  JAX's gradient tree maps onto the port's layout through
jax_params_to_torch, which is linear; each leaf is held at 1e-5 of its
largest value, the bound tests/test_trunk_pallas.py holds the Pallas
backward to."""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.models import CNNPolicy as JCNNPolicy
from rl_collision_avoidance_tpu.ops.trunk_pallas import cnn_pallas_apply

from rl_collision_avoidance_torch.models import CNNPolicy
from rl_collision_avoidance_torch.ops import trunk_cuda
from rl_collision_avoidance_torch.utils.params import jax_params_to_torch

BEAMS = 64     # the mini world's beam count
B = 37
RTOL = 1e-5
F32 = dict(tile_fwd=16, tile_bwd=16, precision="float32", interpret=True)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    scans = rng.uniform(-0.5, 0.5, (B, 3, BEAMS)).astype(np.float32)
    goal = rng.standard_normal((B, 2)).astype(np.float32)
    speed = rng.standard_normal((B, 2)).astype(np.float32)
    model = JCNNPolicy()
    params = model.init(jax.random.PRNGKey(4), scans[:1], goal[:1], speed[:1])
    policy = CNNPolicy(beams=BEAMS)
    policy.load_state_dict(jax_params_to_torch(jax.device_get(params)))
    return model, params, policy, scans, goal, speed


def _loss(v, m, ls):
    # touches every head (and through them both trunks) and logstd
    return (v ** 2).sum() + (m ** 2).sum() + (ls ** 2).sum()


def _port_grads(policy, scans, goal, speed):
    x, g, s = map(torch.from_numpy, (scans, goal, speed))
    feats = trunk_cuda.TwinTrunks.apply(x, *policy.trunk_weights("act"),
                                        *policy.trunk_weights("crt"))
    names, params = zip(*policy.named_parameters())
    grads = torch.autograd.grad(_loss(*policy.heads(feats, g, s)), params)
    return dict(zip(names, grads))


def _assert_tree_close(mine: dict, jax_grads):
    ref = jax_params_to_torch(jax.device_get(jax_grads))
    assert set(mine) == set(ref)
    for name, want in ref.items():
        scale = float(want.abs().max()) + 1e-12
        np.testing.assert_allclose(mine[name].numpy(), want.numpy(),
                                   rtol=0, atol=RTOL * scale, err_msg=name)


def test_backward_matches_pallas_and_flax(setup):
    model, params, policy, scans, goal, speed = setup
    mine = _port_grads(policy, scans, goal, speed)
    loss = lambda fn, p: _loss(*fn(p, scans, goal, speed))
    _assert_tree_close(mine, jax.grad(partial(loss, partial(cnn_pallas_apply,
                                                            **F32)))(params))
    _assert_tree_close(mine, jax.grad(partial(loss, model.apply))(params))


def test_policy_autograd_goes_through_twin_trunks(setup):
    _, _, policy, scans, goal, speed = setup
    v, _, _ = policy(*map(torch.from_numpy, (scans, goal, speed)))
    node, seen = v.grad_fn, set()
    stack = [node]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(n for n, _ in node.next_functions)
    assert any(type(n).__name__ == "TwinTrunksBackward" for n in seen)


def test_grads_wrapper_on_cpu_is_the_plain_version(setup):
    _, _, policy, scans, _, _ = setup
    x = torch.from_numpy(scans)
    act = [w.detach() for w in policy.trunk_weights("act")]
    crt = [w.detach() for w in policy.trunk_weights("crt")]
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, B, 256)).astype(np.float32))
    before = trunk_cuda.bwd_launches
    got = trunk_cuda.twin_trunks_grads(x, act, crt, g)
    want = trunk_cuda.twin_trunks_grads_plain(x, act, crt, g)
    assert trunk_cuda.bwd_launches == before
    for a, b, name in zip((*got[0], *got[1]), (*want[0], *want[1]),
                          trunk_cuda.WEIGHT_NAMES * 2):
        assert torch.equal(a, b), name
    shapes = [tuple(w.shape) for w in act]
    assert [tuple(t.shape) for t in got[0]] == shapes


def test_scans_get_no_gradient(setup):
    """Like the JAX custom_vjp, the trunks do not differentiate the scans;
    asked to, they raise instead of returning zeros."""
    _, _, policy, scans, _, _ = setup
    x = torch.from_numpy(scans).requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient to the scans"):
        trunk_cuda.twin_trunks(x, policy.trunk_weights("act"),
                               policy.trunk_weights("crt"))
