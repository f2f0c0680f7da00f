"""The comparison that decides ``correct`` catches the control and every
fault a cell can have, at a size a test run holds: the program's bf16
mode, and each fault of ``faults.py`` planted under a whole run."""
import importlib.util

import pytest
import torch

from benchmark import faults, spec
from benchmark.tests import cells

_RUN = importlib.util.spec_from_file_location("benchmark_run",
                                              spec.HERE / "run.py")
run = importlib.util.module_from_spec(_RUN)
_RUN.loader.exec_module(run)
SEED = 3_456_789_012
CELLS = {"train": "mini-train", "eval": "circle-eval-1"}
#: The one number that alone catches a fault no other number sees.
ALONE = {"one_leaf": "change_gap_worst", "wrong_resets": "reset_rule_share"}


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_control_is_not_correct(tmp_path, kind):
    cell = cells.load(cells.make_root(tmp_path), CELLS[kind])
    res = run.run(cell, SEED, 0.1, False, "cpu", torch.bfloat16)
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("kind,fault", [(k, f) for k in faults.FAULTS
                                        for f in faults.FAULTS[k]])
def test_fault_is_not_correct(tmp_path, kind, fault):
    cell = cells.load(cells.make_root(tmp_path), CELLS[kind])
    with faults.FAULTS[kind][fault]():
        res = run.run(cell, SEED, 0.1, False, "cpu")
    assert not res["correct"], res["checked"]
    if fault in ALONE:
        failed = {k for k, v in res["checked"].items()
                  if v["value"] is None or v["value"] > v["limit"]}
        assert failed == {ALONE[fault]}, res["checked"]
