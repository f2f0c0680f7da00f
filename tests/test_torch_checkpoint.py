"""Full-state checkpoints (utils/checkpoint.py, Trainer.state_dict /
load_state_dict): a resume is bit-equal to a run without a break, the
manager keeps the newest five and a best one, and the CLI resumes.  The JAX
package's checkpoint tests (tests/test_train.py:48-84) are the template;
no JAX runs here."""
import csv
import dataclasses

import pytest
import torch

from rl_collision_avoidance_torch import cli
from rl_collision_avoidance_torch.algo import PPOConfig
from rl_collision_avoidance_torch.train import TrainConfig, Trainer
from rl_collision_avoidance_torch.utils.checkpoint import CheckpointManager
from rl_collision_avoidance_torch.worlds import get_world


def _trainer(world="mini", seed=0):
    """Horizon 4, two minibatches an epoch, two epochs."""
    arenas = 2 if world == "mini" else 1
    samples = 4 * arenas * get_world(world).n_robots
    cfg = TrainConfig(world=world, n_arenas=arenas, horizon=4, seed=seed,
                      ppo=PPOConfig(batch_size=samples // 2, epochs=2))
    return Trainer(cfg, device="cpu")


def _assert_same(a, b):
    """Two TrainStates hold the same bits."""
    assert a.update == b.update
    for (k, x), (k2, y) in zip(a.policy.state_dict().items(),
                               b.policy.state_dict().items()):
        assert k == k2 and torch.equal(x, y), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, s in oa["state"].items():
        for k, v in s.items():
            w = ob["state"][i][k]
            assert v.device == w.device and torch.equal(v, w), (i, k)
    for f in dataclasses.fields(a.env_state):
        assert torch.equal(getattr(a.env_state, f.name),
                           getattr(b.env_state, f.name)), f.name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("world", ["mini", "stage2"])
def test_resume_is_bit_equal_to_an_unbroken_run(tmp_path, world):
    """k updates, a save, a restore into a fresh Trainer and k more updates
    give the bits of 2k updates without a break: params, Adam, every env
    tensor (dead robots included), both generators and the metrics."""
    k = 2
    tr = _trainer(world)
    straight = tr.init_state()
    metrics = []
    for _ in range(2 * k):
        straight, m = tr.train_step(straight)
        metrics.append(m)
    env_gen = tr.env.generator.get_state()

    tr = _trainer(world)
    state = tr.init_state()
    for _ in range(k):
        state, _ = tr.train_step(state)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state.update, tr.state_dict(state))
    assert mgr.latest_step() == k

    fresh = _trainer(world, seed=123)        # another seed: all state restored
    resumed = fresh.load_state_dict(mgr.restore(k, fresh.device))
    assert resumed.update == k
    for i in range(k):
        resumed, m = fresh.train_step(resumed)
        assert m == metrics[k + i]
    _assert_same(resumed, straight)
    assert torch.equal(fresh.env.generator.get_state(), env_gen)
    if world == "stage2":
        assert straight.env_state.dead.dtype == torch.bool


def test_restore_maps_onto_the_device(tmp_path):
    """restore maps every tensor onto the device it is given (here the
    meta device stands for the card); the generator states stay bytes, and
    load_state_dict leaves Adam's step counts on the host (chip_smoke.py's
    round trip restores onto the card)."""
    tr = _trainer()
    state, _ = tr.train_step(tr.init_state())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tr.state_dict(state))
    meta = mgr.restore(1, torch.device("meta"))
    assert meta["update"] == 1 and isinstance(meta["env_generator"], bytes)
    assert all(v.device.type == "meta" for v in meta["env_state"].values())
    assert all(v.device.type == "meta" for st in
               meta["optimizer"]["state"].values() for v in st.values())
    assert set(meta["env_state"]) == {f.name for f in
                                      dataclasses.fields(state.env_state)}
    restored = tr.load_state_dict(mgr.restore(1, "cpu"))
    steps = [st["step"] for st in restored.optimizer.state_dict()[
        "state"].values()]
    assert steps and all(s.device.type == "cpu" and int(s) == 4   # 2 x 2
                         for s in steps)


def test_trainer_host_loop_saves_and_keeps_five(tmp_path):
    """Every checkpoint_every-th update is saved; the newest five stay."""
    tr = _trainer()
    logs = []
    mgr = CheckpointManager(str(tmp_path / "ck"))
    state = tr.train(updates=12, log_fn=logs.append, checkpoint_manager=mgr,
                     checkpoint_every=2)
    assert len(logs) == 12 and logs[-1]["update"] == 12 == state.update
    assert mgr.latest_step() == 12
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()
                  if p.name.startswith("update_")) == [
        f"update_{s}" for s in sorted((4, 6, 8, 10, 12), key=str)]
    assert (tmp_path / "ck" / "best" / "state.pt").is_file()
    best = float((tmp_path / "ck" / "best_score").read_text().split()[0])
    assert best == max(m["reached"] / max(m["episodes"], 1.0)
                       for m in logs[1::2])


def test_save_best_checkpoint(tmp_path):
    tr = _trainer()
    state = tr.init_state()
    mgr = CheckpointManager(str(tmp_path / "b"))
    assert mgr.save_best(1, tr.state_dict(state), 0.5)
    state, _ = tr.train_step(state)
    assert not mgr.save_best(2, tr.state_dict(state), 0.4)   # worse: not saved
    assert mgr.restore_best()["update"] == 0
    assert mgr.save_best(3, tr.state_dict(state), 0.9)
    best = tr.load_state_dict(mgr.restore_best())
    _assert_same(best, state)


def test_cli_resumes_from_the_newest_checkpoint(tmp_path):
    """train-stage1 --checkpoint-dir D --resume continues from D/stage1's
    newest update (here one saved by a Trainer of the same settings); the
    metrics log carries on from its update counter."""
    cfg = TrainConfig.stage1(n_arenas=1, seed=0)
    cfg.world = "mini"
    cfg.ppo = cfg.ppo._replace(batch_size=256)
    tr = Trainer(cfg, device="cpu")
    state, _ = tr.train_step(tr.init_state())
    CheckpointManager(str(tmp_path / "ck" / "stage1")).save(
        state.update, tr.state_dict(state))
    cli.main(["train-stage1", "--world", "mini", "--updates", "1",
              "--batch-size", "256", "--device", "cpu", "--log-dir",
              str(tmp_path / "log"), "--checkpoint-dir",
              str(tmp_path / "ck"), "--resume"])
    with open(tmp_path / "log" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [float(r["update"]) for r in rows] == [2.0]
    with pytest.raises(SystemExit):
        cli.main(["train-stage1", "--resume", "--device", "cpu"])
