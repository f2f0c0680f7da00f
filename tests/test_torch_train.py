"""The port's stage-1 trainer (train/trainer.py) against a JAX chain built
from the JAX package's public pieces (Env.step, CNNPolicy.apply,
distributions, gae, normalize_advantages, ppo_update) on mini, with the
same params, env state, sampling noise, reset draws and minibatch
permutations; plus determinism, the host loop's log files, the params npz
round trip and the CLI."""
import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.engine.env import Env as JEnv
from rl_collision_avoidance_tpu.models import CNNPolicy as JCNNPolicy
from rl_collision_avoidance_tpu.utils.checkpoint import load_params_npz
from rl_collision_avoidance_tpu.worlds import mini as jmini

from rl_collision_avoidance_torch import cli
from rl_collision_avoidance_torch.algo import PPOConfig
from rl_collision_avoidance_torch.train import TrainConfig, Trainer
from rl_collision_avoidance_torch.utils.metrics import MetricLogger
from rl_collision_avoidance_torch.utils.params import (jax_params_to_torch,
                                                       load_jax_npz,
                                                       save_params_npz,
                                                       torch_to_jax_params)
from torch_parity import assert_one_update_matches_jax

ROOT = Path(__file__).resolve().parents[1]
ARENAS, HORIZON, BATCH, EPOCHS = 3, 8, 32, 2   # 96 samples, 3 minibatches


def test_one_update_matches_jax_chain():
    jspec = jmini()
    n, beams = jspec.n_robots, jspec.n_beams
    model = JCNNPolicy()
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, beams)),
                        jnp.zeros((1, 2)), jnp.zeros((1, 2)))
    # Robots of arena 0 start near the timeout, so episodes end inside the
    # rollout: GAE cuts, episode returns and in-step resets are exercised.
    steps = np.zeros((ARENAS, n), np.int32)
    steps[0] = [146, 147, 148, 149]
    cfg = TrainConfig(world="mini", n_arenas=ARENAS, horizon=HORIZON,
                      ppo=PPOConfig(batch_size=BATCH, epochs=EPOCHS))
    metrics, jm = assert_one_update_matches_jax(
        cfg, JEnv(jspec, lidar_mode="pallas"), model, params, steps)
    assert jm["episodes"] >= 4


def _mini_trainer(seed=0):
    cfg = TrainConfig(world="mini", n_arenas=2, horizon=8, seed=seed,
                      ppo=PPOConfig(batch_size=16, epochs=1))
    return Trainer(cfg, device="cpu")


def test_train_determinism():
    """Two CPU runs from the same seed give identical params."""
    out = []
    for _ in range(2):
        tr = _mini_trainer(seed=5)
        state = tr.train(updates=2)
        out.append(state.policy.state_dict())
    for k, v in out[0].items():
        assert torch.equal(v, out[1][k]), k


def test_train_loop_writes_the_jax_logs(tmp_path):
    """Trainer.train with MetricLogger writes the JAX package's log files;
    metrics.csv has the columns of the committed stage-1 curve plus
    steps_per_s_ema, which the JAX Trainer.train adds (trainer.py:310),
    the port's ``waiting`` count and the update's CUDA-graph counts."""
    logger = MetricLogger(str(tmp_path), stdout=False)
    state = _mini_trainer().train(updates=2, log_fn=logger.log_update)
    assert state.update == 2
    for name in ("output.log", "cal.log", "ppo.log"):
        assert len((tmp_path / name).read_text().splitlines()) == 2, name
    with open(tmp_path / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    with open(ROOT / "results" / "stage1_metrics.csv") as f:
        curve = next(csv.reader(f))
    assert sorted(rows[0]) == sorted(curve + ["steps_per_s_ema", "waiting",
                                              "graph_captures",
                                              "graph_replays"])
    assert [float(r["update"]) for r in rows] == [1.0, 2.0]
    assert all(np.isfinite(float(r["value_loss"])) for r in rows)


def test_params_npz_round_trip(tmp_path):
    """save_params_npz -> the JAX package's load_params_npz gives the leaves
    the port holds, the JAX apply on them equals the port's forward, and
    load_jax_npz brings them back."""
    torch.manual_seed(0)
    tr = _mini_trainer()
    policy = tr.init_state().policy
    path = tmp_path / "p.npz"
    save_params_npz(path, torch_to_jax_params(policy.state_dict()))
    model = JCNNPolicy()
    tmpl = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64)),
                      jnp.zeros((1, 2)), jnp.zeros((1, 2)))
    loaded = load_params_npz(str(path), tmpl)
    assert (jax.tree_util.tree_structure(loaded)
            == jax.tree_util.tree_structure(tmpl))
    for k, v in jax_params_to_torch(jax.device_get(loaded)).items():
        assert torch.equal(v, policy.state_dict()[k]), k
    for k, v in jax_params_to_torch(load_jax_npz(path)).items():
        assert torch.equal(v, policy.state_dict()[k]), k
    rng = np.random.default_rng(2)
    x = (rng.uniform(-0.5, 0.5, (6, 3, 64)).astype(np.float32),
         rng.standard_normal((6, 2)).astype(np.float32),
         rng.standard_normal((6, 2)).astype(np.float32))
    ref = model.apply(loaded, *x)
    with torch.no_grad():
        mine = policy(*map(torch.from_numpy, x))
    for r, o in zip(ref, mine):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   atol=2e-5)


def test_cli_train_stage1(tmp_path):
    """train-stage1 on the CPU: logs, a params npz the JAX package loads,
    and --warm-start from it."""
    args = ["train-stage1", "--world", "mini", "--arenas", "1", "--updates",
            "1", "--batch-size", "256", "--device", "cpu", "--log-dir",
            str(tmp_path / "log")]
    cli.main(args + ["--out", str(tmp_path / "a.npz")])
    assert (tmp_path / "log" / "metrics.csv").is_file()
    first = load_jax_npz(tmp_path / "a.npz")
    cli.main(args + ["--warm-start", str(tmp_path / "a.npz"), "--logstd-min",
                     "0.0"])
    second = load_jax_npz(tmp_path / "log" / "stage1_params.npz")
    assert np.all(second["params"]["logstd"] >= 0.0)
    moved = [np.abs(a - b).max() for a, b in zip(
        jax.tree_util.tree_leaves(first), jax.tree_util.tree_leaves(second))]
    assert 0 < max(moved) < 1e-2    # one update of lr 5e-5 from the warm start


@pytest.mark.parametrize("arenas", [1, 4])
def test_stage1_preset_scales_the_batch(arenas):
    cfg = TrainConfig.stage1(n_arenas=arenas)
    assert cfg.ppo.batch_size == 1024 * arenas and cfg.horizon == 128
    assert (cfg.ppo.epochs, cfg.ppo.clip_value, cfg.ppo.coeff_entropy,
            cfg.ppo.learning_rate, cfg.gamma, cfg.lam) == (2, 0.1, 5e-4, 5e-5,
                                                           0.99, 0.95)
