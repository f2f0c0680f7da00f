"""Every cell, configuration, traffic, limit and metric of BENCHMARK.json
is found by name, and the file keeps to the benchmark's contract."""
import json
import re

import pytest

from benchmark import spec
from benchmark.tests import cells

BENCH = json.loads((spec.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = spec.load(cell)
    assert c.traffic["kind"] in ("train", "eval")
    assert hasattr(c.driver(), "Session")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(c.metric_reader(m["name"]).read)
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells_ = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells_
        if m["name"].endswith("roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and not c["reduced"]
        assert json.loads((spec.REPO / c["file"]).read_text())["name"] \
            == c["name"]
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert NAME.match(entry["name"]) and 1 <= len(entry["why"]) <= 200
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    for path in spec.HERE.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.fullmatch(r"[A-Za-z0-9_.-]+", path.name), path
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_is_only_files(tmp_path):
    """A configuration, traffic, limits and cell added as files and
    entries of another BENCHMARK.json load with the same code."""
    bench = cells.make_root(tmp_path)
    for name in ("mini-train", "circle-eval-1"):
        c = cells.load(bench, name)
        assert c.root == bench.parent
        assert {m["name"] for m in c.per_layer}
