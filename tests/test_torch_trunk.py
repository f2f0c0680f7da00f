"""The port's twin-trunk forward (ops/trunk_cuda.py, plain version on the
CPU) against the JAX package's fused Pallas trunks in exact float32 and
interpret mode, and against the flax CNNPolicy apply.  B = 40 is not a
multiple of either package's tile."""
import jax
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.models import CNNPolicy as JCNNPolicy
from rl_collision_avoidance_tpu.ops.trunk_pallas import (TrunkConfig,
                                                         cnn_pallas_apply,
                                                         fused_trunks,
                                                         stack_trunk_params)

from rl_collision_avoidance_torch.models import CNNPolicy
from rl_collision_avoidance_torch.ops import trunk_cuda
from rl_collision_avoidance_torch.utils.params import jax_params_to_torch

ATOL = 3e-6
F32 = dict(tile_fwd=16, tile_bwd=16, precision="float32", interpret=True)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    b = 40
    scans = rng.standard_normal((b, 3, 512)).astype(np.float32)
    goal = rng.standard_normal((b, 2)).astype(np.float32)
    speed = rng.standard_normal((b, 2)).astype(np.float32)
    model = JCNNPolicy()
    params = model.init(jax.random.PRNGKey(0), scans[:1], goal[:1], speed[:1])
    policy = CNNPolicy()
    policy.load_state_dict(jax_params_to_torch(jax.device_get(params)))
    return model, params, policy, scans, goal, speed


def test_plain_trunks_match_pallas_f32(setup):
    _, params, policy, scans, _, _ = setup
    ref = fused_trunks(stack_trunk_params(params["params"]), scans,
                       TrunkConfig(**F32))
    with torch.no_grad():
        mine = trunk_cuda.twin_trunks_plain(torch.from_numpy(scans),
                                            policy.trunk_weights("act"),
                                            policy.trunk_weights("crt"))
    assert mine.shape == (2, 40, 256)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=ATOL)


def test_forward_matches_pallas_apply_and_flax(setup):
    model, params, policy, scans, goal, speed = setup
    with torch.no_grad():
        mine = policy(*map(torch.from_numpy, (scans, goal, speed)))
    for ref in (cnn_pallas_apply(params, scans, goal, speed, **F32),
                model.apply(params, scans, goal, speed)):
        for r, m in zip(ref, mine):
            np.testing.assert_allclose(m.detach().numpy(), np.asarray(r),
                                       atol=ATOL)


def test_wrapper_on_cpu_is_the_plain_version(setup):
    _, _, policy, scans, _, _ = setup
    x = torch.from_numpy(scans)
    act, crt = policy.trunk_weights("act"), policy.trunk_weights("crt")
    before = trunk_cuda.launches
    with torch.no_grad():
        got = trunk_cuda.twin_trunks(x, act, crt)
        want = trunk_cuda.twin_trunks_plain(x, act, crt)
    assert trunk_cuda.launches == before
    assert torch.equal(got, want)


def test_exact_float32_restores_settings():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    with trunk_cuda.exact_float32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == prev
