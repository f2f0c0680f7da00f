"""Each cell of BENCHMARK.json end to end on the card, briefly: the
result line, its keys, and ``correct``.  Runs where a CUDA card is
visible; the skip is decided inside the test."""
import json
import subprocess
import sys

import pytest

from benchmark import spec

BENCH = json.loads((spec.REPO / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload", cell,
         "--seed", "2147483711", "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=spec.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checked"
    assert result["correct"], result["checked"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
