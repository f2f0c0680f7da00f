"""The port's results pipeline (examples/make_results.py) against the JAX
package's ``examples/make_results.py`` and ``examples/circle_ft_bf16.py``,
on the CPU at small sizes: the selection score, the selection loop's rule
(strictly better, so a tie keeps the earlier params) and what it writes, one
bf16 circle_ft update against JAX's, the sweep's keys against the committed
``results/circle_eval.json``, the 12-robot ring, and ``main`` from the eval
on.  Nothing here reads ``stage2_params.npz`` or the bf16 params, which the
``git archive`` export leaves out."""
import csv
import dataclasses
import importlib.util
import json
import shutil
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.engine.env import Env as JEnv
from rl_collision_avoidance_tpu.models import CNNPolicy as JCNNPolicy
from rl_collision_avoidance_tpu.algo import ppo as jppo
from rl_collision_avoidance_tpu.worlds import circle as jcircle
from rl_collision_avoidance_tpu.worlds import circle_train as jcircle_train

from rl_collision_avoidance_torch.examples import make_results
from rl_collision_avoidance_torch.train import TrainConfig, Trainer
from rl_collision_avoidance_torch.utils.params import (jax_params_to_torch,
                                                       load_jax_npz)
from rl_collision_avoidance_torch.worlds import circle
from torch_parity import (DELTA_NORM, jax_params, jax_reset_draw,
                          jax_update)

ROOT = Path(__file__).resolve().parents[1]
RESULTS = ROOT / "results"
BF16 = torch.bfloat16


def _jax_script():
    """The JAX package's examples/make_results.py as a module (it puts the
    repository on sys.path itself)."""
    spec = importlib.util.spec_from_file_location(
        "jax_make_results", ROOT / "examples" / "make_results.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def two_threads():
    """Two intra-op threads (the suite runs several workers at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_select_score_is_the_jax_one():
    jmr = _jax_script()
    assert make_results.SELECT_NOISE == jmr.SELECT_NOISE
    evs = [{"success_rate_mean": s, "collisions_mean": c}
           for s, c in ((1.0, 0.0), (0.954375, 1.0), (0.5, 3.25),
                        (0.0, 50.0), (0.9724999999999999, 0.6875))]
    for ev in evs:
        assert make_results.select_score(ev) == jmr._select_score(ev), ev


def test_circle_selection_keeps_the_first_best(tmp_path, monkeypatch,
                                               two_threads):
    """circle_train, one arena, horizon 8, three chunks of one update, the
    selection evals scripted to scores 0.496, 0.898, 0.898: the params
    after chunk 2 are kept (a tie keeps the earlier), the curve has the
    scripted rows, and the phase record has the keys of the JAX script's
    (the committed results/META.json circle_ft phase)."""
    scripted = [(0.5, 2.0), (0.9, 1.0), (0.9, 1.0)]
    seen = []

    def scripted_eval(policy, **kw):
        assert policy.dtype == torch.float32
        assert kw == {"max_steps": 5, "n_arenas": 8, "pose_noise": 0.3}
        seen.append({k: v.clone() for k, v in policy.state_dict().items()})
        success, coll = scripted[len(seen) - 1]
        return {"success_rate_mean": success, "collisions_mean": coll}

    monkeypatch.setattr(make_results, "run_circle_eval", scripted_eval)
    ppo = TrainConfig.circle_ft().ppo._replace(batch_size=80)
    record = make_results.train(
        "circle_ft", 3, 1, str(tmp_path),
        warm_start=str(RESULTS / "circle_ft_params.npz"),
        circle_select_every=1, device="cpu", select_steps=5, horizon=8,
        ppo=ppo)
    assert len(seen) == 3
    kept = jax_params_to_torch(load_jax_npz(tmp_path / "circle_ft_params.npz"))
    for k, v in seen[1].items():
        assert torch.equal(kept[k], v), k
    assert not all(torch.equal(seen[0][k], v) for k, v in seen[1].items())
    with open(tmp_path / "circle_ft_circle_curve.csv") as f:
        rows = list(csv.DictReader(f))
    assert rows == [{"update": str(i + 1), "circle_success_mean": str(s),
                     "collisions_mean": str(c)}
                    for i, (s, c) in enumerate(scripted)]
    with open(tmp_path / "circle_ft_metrics.csv") as f:
        assert [float(r["update"]) for r in csv.DictReader(f)] == [1, 2, 3]
    jax_record = next(ph for ph in json.loads(
        (RESULTS / "META.json").read_text())["phases"]
        if ph["stage"] == "circle_ft")
    assert list(record) == list(jax_record)
    assert record["circle_select_best_score"] == round(0.9 - 0.002, 4)
    assert (record["circle_select_every"], record["circle_select_noise_m"],
            record["updates"], record["horizon"], record["batch_size"],
            record["epochs"]) == (1, 0.3, 3, 8, 80, 4)


def test_one_bf16_circle_ft_update_matches_jax(two_threads):
    """One circle_ft update in bf16 (bf16 policy and scan storage, as
    circle_ft_bf16.py trains) from the fine-tuned weights, one arena of 50,
    horizon 8 with every robot's timeout inside it, against the JAX
    Trainer's bf16 update on the same draws (sampling noise, reset draws,
    minibatch orders).  As in tests/test_torch_bf16.py, two bf16 updates
    cannot hold the float32 rule, and each is held by its distance from the
    float32 update (the port's, on the same draws, itself held to JAX's in
    tests/test_torch_circle.py).  Here the rollout is bf16 too: its means
    differ between XLA and torch by an ulp here and there (XLA's bf16
    logistic), so the two bf16 updates train on batches that differ by
    bf16 rounding and each is one draw of that noise, at about JAX's
    distance from float32, and the two about sqrt(2) of it apart (read:
    1.31 and 1.37 over all parameters; per leaf the port's at most 2.07
    times JAX's).  So over all parameters the port's within twice JAX's
    distance and the two apart by at most twice it; per leaf the port's
    within three times JAX's plus DELTA_NORM of the float32 change.  A
    wrong cast or a lost bf16 rounding moves a leaf by a share of its whole
    change, several times these (JAX's distance is 9% of the float32 change
    over all parameters).  The metrics likewise: each within twice JAX's
    distance from float32 plus 1e-3 of the value; episode counts equal."""
    cfg = TrainConfig.circle_ft(n_arenas=1, horizon=8)
    cfg.ppo = cfg.ppo._replace(batch_size=80)
    cfg16 = dataclasses.replace(cfg, policy_dtype=BF16, obs_store_dtype=BF16)
    steps = (693 + np.arange(50) % 8).astype(np.int32)[None]
    _, params = jax_params(RESULTS / "circle_ft_params.npz")
    jenv = JEnv(jcircle_train(), lidar_mode="xla", obs_dtype=jnp.bfloat16)
    n, seed = 50, 2
    keys = jax.random.split(jax.random.PRNGKey(seed), 1)
    jstate, _ = jenv.reset(keys)
    jstate = jstate.replace(step=jnp.asarray(steps))
    noise = np.random.default_rng(seed).standard_normal(
        (cfg.horizon, n, 2)).astype(np.float32)
    key = jax.random.PRNGKey(seed + 1)
    p = cfg.ppo
    jcfg = jppo.PPOConfig(batch_size=p.batch_size, epochs=p.epochs,
                          clip_value=p.clip_value,
                          coeff_entropy=p.coeff_entropy,
                          value_coeff=p.value_coeff,
                          learning_rate=p.learning_rate,
                          logstd_min=p.logstd_min)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnew, jm, resets = jax_update(jenv, JCNNPolicy(dtype=jnp.bfloat16),
                                      params, jstate, noise, key, jcfg)
    m = cfg.horizon * n
    perms = torch.from_numpy(np.stack(
        [np.asarray(jax.random.permutation(k, m))
         for k in jax.random.split(key, p.epochs)]))

    def port_update(c):
        tr = Trainer(c, device="cpu")
        state = tr.init_state()
        state.policy.load_state_dict(jax_params_to_torch(
            jax.device_get(params)))
        env_state, _ = tr.env.reset(1, *jax_reset_draw(
            jenv, keys, jnp.zeros((1, n, 3))))
        env_state.step = torch.from_numpy(steps)
        state.env_state = env_state
        before = {k: v.clone() for k, v in state.policy.state_dict().items()}
        state, metrics = tr.train_step(state, noise=torch.from_numpy(noise),
                                       resets=resets, perms=perms)
        return {k: v - before[k] for k, v in
                state.policy.state_dict().items()}, metrics

    mine, metrics = port_update(cfg16)
    exact, m32 = port_update(cfg)
    assert set(metrics) == set(jm)
    for k in ("episodes", "reached", "crashed", "waiting", "env_steps"):
        assert metrics[k] == jm[k] == m32[k], k
    for k in ("policy_loss", "value_loss", "entropy", "ep_return_sum",
              "reward_mean"):
        assert abs(metrics[k] - jm[k]) <= (2 * abs(jm[k] - m32[k])
                                           + 1e-3 * abs(m32[k])), k
    jdelta = jax_params_to_torch(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b),
        jax.device_get(jnew), jax.device_get(params)))
    norm = np.linalg.norm
    total = np.zeros(3)
    for name, ref in jdelta.items():
        delta = mine[name].numpy().ravel()
        ref, f32 = ref.numpy().ravel(), exact[name].numpy().ravel()
        mine_err, jax_err = norm(delta - f32), norm(ref - f32)
        total += np.square([mine_err, jax_err, norm(delta - ref)])
        assert mine_err <= 3 * jax_err + DELTA_NORM * norm(f32), name
    mine_err, jax_err, apart = np.sqrt(total)
    assert mine_err <= 2 * jax_err
    assert apart <= 2 * jax_err


def test_evaluate_writes_the_committed_keys(tmp_path, two_threads):
    """evaluate() at 3 steps and 2 arenas, with a stage-2 block (from the
    fine-tuned weights: stage2_params.npz is not in the export), writes the
    keys of the committed results/circle_eval.json, each row's included."""
    params = str(RESULTS / "circle_ft_params.npz")
    out = make_results.evaluate(params, str(tmp_path), params, steps=3,
                                arenas=2, device="cpu", plots=False)
    written = json.loads((tmp_path / "circle_eval.json").read_text())
    committed = json.loads((RESULTS / "circle_eval.json").read_text())
    assert written == out

    def same_keys(got, want):
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, dict):
                same_keys(got[k], v)

    same_keys(written, committed)
    assert written["ring_12_robots"]["n_robots"] == 12
    for k in ("jitter_0.1m", "jitter_0.3m", "jitter_1.0m"):
        assert written[k]["n_arenas"] == 2 and written[k]["max_steps"] == 3
        assert written[k]["pose_noise_m"] == float(k[7:-1])


def test_ring_12_robots_is_the_jax_world():
    mine, ref = circle(n_robots=12), jcircle(n_robots=12)
    assert mine.n_robots == ref.n_robots == 12
    for f in dataclasses.fields(ref):
        a, b = getattr(mine, f.name, None), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_main_from_the_eval_writes_meta(tmp_path, two_threads):
    """``main --from-stage eval`` on the CPU at 3 steps over 2 arenas, from
    a params directory holding the committed circle_ft_params.npz and
    META.json: circle_eval.json (no stage-2 block: no stage2_params.npz
    there) and META.json with the committed file's keys and its three
    phase records carried forward."""
    params_dir, root = tmp_path / "params", tmp_path / "out"
    params_dir.mkdir()
    for name in ("circle_ft_params.npz", "META.json"):
        shutil.copy(RESULTS / name, params_dir / name)
    meta = make_results.main(["--from-stage", "eval", "--params-dir",
                              str(params_dir), "--eval-steps", "3",
                              "--eval-arenas", "2", "--no-plots", "--device",
                              "cpu", "--root", str(root)])
    written = json.loads((root / "META.json").read_text())
    committed = json.loads((RESULTS / "META.json").read_text())
    assert written == meta
    assert set(written) == set(committed)
    assert written["phases"] == committed["phases"]
    assert written["reused_stages"] == ["stage1", "stage2", "circle_ft"]
    assert written["device"] == "cpu"
    sweep = json.loads((root / "circle_eval.json").read_text())
    assert "stage2_policy" not in sweep
    assert sweep["deterministic"]["max_steps"] == 3
    assert sorted(p.name for p in root.iterdir()) == ["META.json",
                                                      "circle_eval.json"]


@pytest.mark.parametrize("argv", [["--root", str(RESULTS)],
                                  ["--obs-bf16"]])
def test_main_refuses(argv, tmp_path, capsys):
    """main writes nowhere into the repository's results/, and --obs-bf16
    needs --bf16; both refused before anything runs."""
    before = sorted(p.name for p in RESULTS.iterdir())
    with pytest.raises(SystemExit):
        make_results.main(argv + ["--device", "cpu", "--params-dir",
                                  str(tmp_path)])
    assert sorted(p.name for p in RESULTS.iterdir()) == before
    assert "error" in capsys.readouterr().err
