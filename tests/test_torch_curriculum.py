"""The port's curriculum entry point (examples/train_curriculum.py) on the
CPU at its smallest: one arena and one update a stage, a checkpoint every
update, a five-step eval.  It writes both params npz files, the logs and
the eval's JSON line, and stage 2 starts bit-equal from the best stage-1
checkpoint's params."""
import json
import os

import numpy as np
import pytest
import torch

from rl_collision_avoidance_torch.examples import train_curriculum
from rl_collision_avoidance_torch.train import Trainer
from rl_collision_avoidance_torch.utils.checkpoint import CheckpointManager
from rl_collision_avoidance_torch.utils.params import (jax_params_to_torch,
                                                       load_jax_npz)

TINY = ["--device", "cpu", "--updates", "1", "1", "--arenas", "1", "1", "1",
        "--checkpoint-every", "1", "--max-steps", "5"]


@pytest.fixture
def two_threads():
    """Two intra-op threads for the run: the suite runs several workers,
    each with torch's default of one thread a core, and a run spread over
    every core then waits on the other workers' threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_curriculum_tiny(tmp_path, monkeypatch, capsys, two_threads):
    starts = {}
    train = Trainer.train

    def recording_train(self, state=None, **kw):
        starts[self.cfg.world] = {k: v.clone() for k, v in
                                  state.policy.state_dict().items()}
        return train(self, state, **kw)

    monkeypatch.setattr(Trainer, "train", recording_train)
    out = train_curriculum.main(TINY + ["--root", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out["eval"]
    ring, jitter = out["eval"]["deterministic_symmetric"], out["eval"][
        "jitter_1.0m"]
    assert ring["n_robots"] == jitter["n_robots"] == 50
    assert ring["max_steps"] == 5 and jitter["pose_noise_m"] == 1.0
    for stage in ("stage1", "stage2"):
        path = tmp_path / "checkpoints" / f"{stage}_params.npz"
        assert out[f"{stage}_params"] == str(path) and path.is_file()
        assert (tmp_path / "log" / stage / "metrics.csv").is_file()
        assert any(line.startswith(f"{stage}: 1 updates of 1 arenas in ")
                   for line in lines)
        best = CheckpointManager(str(tmp_path / "checkpoints" / stage)
                                 ).restore_best("cpu")["policy"]
        saved = jax_params_to_torch(load_jax_npz(path))
        for k, v in best.items():
            assert torch.equal(saved[k], v), (stage, k)
    # stage 2 started from the best stage-1 params, bit for bit
    best1 = jax_params_to_torch(load_jax_npz(out["stage1_params"]))
    assert set(starts) == {"stage1", "stage2"}
    for k, v in best1.items():
        assert torch.equal(starts["stage2"][k], v), k
    assert not all(torch.equal(starts["stage1"][k], v)
                   for k, v in best1.items())


def test_curriculum_refuses_a_used_root(tmp_path):
    """An earlier run's best checkpoint would compete with this run's, so a
    root that holds stage checkpoints is refused before any training."""
    old = tmp_path / "checkpoints" / "stage1" / "update_25"
    old.mkdir(parents=True)
    with pytest.raises(FileExistsError, match="earlier run"):
        train_curriculum.main(TINY + ["--root", str(tmp_path)])
    assert not os.path.exists(tmp_path / "log")
