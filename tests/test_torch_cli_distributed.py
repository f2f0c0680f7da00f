"""The port's CLI launched as two ranks on the CPU (gloo), the counterpart
of tests/test_cli_distributed.py: both ranks train, rank 0 alone writes
the metrics log and the params npz, and a multi-process run refuses the
single-process full-state checkpoint."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from rl_collision_avoidance_torch import cli

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_two_process_launch(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join([str(ROOT),
                                          os.environ.get("PYTHONPATH", "")])}
    base = [sys.executable, "-m", "rl_collision_avoidance_torch.cli",
            "train-stage1", "--device", "cpu", "--world", "mini",
            "--arenas", "2", "--updates", "2", "--batch-size", "512",
            "--coordinator", f"127.0.0.1:{_free_port()}",
            "--num-processes", "2"]
    procs = [subprocess.Popen(
        base + ["--process-id", str(i), "--log-dir", str(tmp_path / f"log{i}")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"a CLI rank failed:\n{out[-3000:]}"
    rows = (tmp_path / "log0" / "metrics.csv").read_text().strip()
    assert len(rows.splitlines()) == 1 + 2     # header + 2 updates
    assert (tmp_path / "log0" / "stage1_params.npz").is_file()
    # rank 1 writes nothing: no log directory at all
    assert not (tmp_path / "log1").exists()


@pytest.mark.parametrize("flags", [["--checkpoint-dir", "ck"],
                                   ["--checkpoint-dir", "ck", "--resume"]])
def test_cli_refuses_checkpoints_with_more_than_one_process(flags):
    with pytest.raises(SystemExit, match="single-process"):
        cli.main(["train-stage1", "--device", "cpu", "--world", "mini",
                  "--coordinator", "127.0.0.1:1", "--num-processes", "2",
                  "--process-id", "0", *flags])
