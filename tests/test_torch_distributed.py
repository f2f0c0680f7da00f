"""Multi-process training on the CPU: one ``Trainer.train_step`` on mini
split over two gloo ranks (worker processes, tests/torch_dist_worker.py)
against the JAX chain of ``torch_parity.jax_update`` with its PPO step
swapped for the JAX package's ``ppo_update_sharded`` on a two-device
mesh, the counterpart of tests/test_distributed.py.  Each rank takes its
slice of the arenas' state, the sampling noise, the reset draws and its
shard's minibatch orders; the metrics are global."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from rl_collision_avoidance_tpu.algo import ppo as jppo
from rl_collision_avoidance_tpu.engine.env import Env as JEnv
from rl_collision_avoidance_tpu.models import CNNPolicy as JCNNPolicy
from rl_collision_avoidance_tpu.parallel import DATA_AXIS, make_mesh
from rl_collision_avoidance_tpu.worlds import mini as jmini

from rl_collision_avoidance_torch.utils.params import jax_params_to_torch
from test_torch_sharded_ppo import _jax_shard_perms
from torch_dist_worker import run_ranks
from torch_parity import (METRIC_RTOL, assert_update_matches_jax,
                          jax_reset_draw, jax_update)

ARENAS, HORIZON, BATCH, EPOCHS, WORLD = 4, 4, 32, 2, 2   # 64 samples
SEED = 2


def jax_sharded_update(monkeypatch, *args):
    """``torch_parity.jax_update`` with its ``ppo_update`` call replaced by
    ``ppo_update_sharded`` over a WORLD-device mesh (the JAX trainer's
    step, ``train/trainer.py:256-259``)."""
    mesh = make_mesh(WORLD)
    monkeypatch.setattr(jppo, "ppo_update", lambda apply_fn, params, opt,
                        tx, batch, key, cfg: jppo.ppo_update_sharded(
                            apply_fn, params, opt, tx, batch, key, cfg,
                            mesh, DATA_AXIS))
    return jax_update(*args)


def test_two_rank_train_step_matches_jax_sharded_chain(tmp_path,
                                                       monkeypatch):
    jspec = jmini()
    jenv = JEnv(jspec, lidar_mode="pallas")
    n = jspec.n_robots
    model = JCNNPolicy()
    params = model.init(jax.random.PRNGKey(1),
                        jnp.zeros((1, 3, jspec.n_beams)), jnp.zeros((1, 2)),
                        jnp.zeros((1, 2)))
    # one arena of each rank starts near the timeout, so episodes end and
    # robots reset inside the rollout on both ranks
    steps = np.zeros((ARENAS, n), np.int32)
    steps[0] = steps[ARENAS - 1] = [146, 147, 148, 149]
    keys = jax.random.split(jax.random.PRNGKey(SEED), ARENAS)
    jstate, _ = jenv.reset(keys)
    jstate = jstate.replace(step=jnp.asarray(steps))
    noise = np.random.default_rng(SEED).standard_normal(
        (HORIZON, ARENAS * n, 2)).astype(np.float32)
    key = jax.random.PRNGKey(SEED + 1)
    jcfg = jppo.PPOConfig(batch_size=BATCH, epochs=EPOCHS)
    jnew, jm, resets = jax_sharded_update(monkeypatch, jenv, model, params,
                                          jstate, noise, key, jcfg)
    m_local = HORIZON * ARENAS * n // WORLD
    perms = _jax_shard_perms(key, EPOCHS, m_local, m_local, WORLD)
    pose, goal = jax_reset_draw(jenv, keys, jnp.zeros((ARENAS, n, 3)))
    start = jax_params_to_torch(jax.device_get(params))
    outs = run_ranks("train", {
        "arenas": ARENAS, "params": start, "pose": pose, "goal": goal,
        "steps": torch.from_numpy(steps), "noise": torch.from_numpy(noise),
        "resets": resets, "perms": torch.from_numpy(perms),
        "ppo": {"batch_size": BATCH, "epochs": EPOCHS}}, tmp_path)
    a, b = (o["params"] for o in outs)
    assert all(torch.equal(v, b[k]) for k, v in a.items())
    assert outs[0]["metrics"] == outs[1]["metrics"]
    metrics = outs[0]["metrics"]
    assert set(metrics) == set(jm)
    for k, want in jm.items():
        np.testing.assert_allclose(metrics[k], want, rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)
    assert jm["episodes"] >= 6    # the near-timeout arenas: 147-149 end
    assert_update_matches_jax(start, a, params, jnew)
