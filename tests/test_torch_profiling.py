"""Tracing and the NaN guard of the port (utils/profiling.py), as the JAX
package's: ``Trainer.train(profile_dir=)`` and the CLI's ``--profile``
leave a trace, ``nan_debug`` raises at a NaN-producing backward; and the
CLI's ``bench`` subcommand and ``bench --scaling``."""
import json

import pytest
import torch

from rl_collision_avoidance_torch import bench, cli
from rl_collision_avoidance_torch.algo import PPOConfig
from rl_collision_avoidance_torch.train import TrainConfig, Trainer
from rl_collision_avoidance_torch.utils.profiling import nan_debug, trace


def _trace_names(path) -> set:
    return {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}


def test_train_with_profile_dir_leaves_a_trace(tmp_path):
    cfg = TrainConfig(world="mini", n_arenas=1, horizon=4,
                      ppo=PPOConfig(batch_size=8, epochs=1))
    state = Trainer(cfg, device="cpu").train(updates=3,
                                             profile_dir=str(tmp_path))
    assert state.update == 3
    path = tmp_path / "rank0.pt.trace.json"
    assert path.is_file()
    assert {"rollout", "gae", "ppo_forward", "adam"} <= _trace_names(path)


def test_cli_profile_flag(tmp_path):
    cli.main(["train-stage1", "--device", "cpu", "--world", "mini",
              "--updates", "2", "--batch-size", "256", "--log-dir",
              str(tmp_path / "log"), "--profile", str(tmp_path / "trace")])
    assert (tmp_path / "trace" / "rank0.pt.trace.json").is_file()


def test_trace_writes_even_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError):
        with trace(str(tmp_path)):
            torch.ones(3).sum()
            raise ValueError("stop")
    assert (tmp_path / "rank0.pt.trace.json").is_file()


def test_nan_debug_raises_on_a_nan_backward():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with nan_debug():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x).sum().backward()     # outside the block: no check
    assert torch.isnan(x.grad[0])


def test_cli_bench_forwards(monkeypatch):
    seen = []
    monkeypatch.setattr(bench, "main", seen.append)
    cli.main(["bench", "--train", "--arenas", "4"])
    assert seen == [["--train", "--arenas", "4"]]


def test_bench_scaling_prints_its_json_line(capsys):
    bench.main(["--scaling", "2", "--steps", "32", "--warmup", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "cpu_scaling_efficiency_2proc"
    assert out["device"] == "cpu" and out["value"] > 0
    assert out["steps_per_s_2proc"] > 0 and out["steps_per_s_1proc"] > 0


@pytest.mark.parametrize("flags", [["--train"], ["--bf16", "--world", "mini"],
                                   ["--footprint", "rect"]],
                         ids=["train", "bf16 and world", "footprint"])
def test_bench_scaling_refuses_flags_it_ignores(flags, capsys):
    """--scaling times random-policy acting on mini: a flag that would set
    another configuration is refused, not silently dropped."""
    with pytest.raises(SystemExit):
        bench.main(["--scaling", "2", *flags])
    err = capsys.readouterr().err
    assert "--scaling" in err
    assert all(f in err for f in flags if f.startswith("--"))
