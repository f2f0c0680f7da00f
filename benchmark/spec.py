"""What a cell is, found by name: its entry in ``BENCHMARK.json``, its
configuration ``configs/<config>.json``, its traffic ``traffic/<traffic>.json``
(whose ``kind`` names ``drivers/<kind>.py``), its limits
``limits/<cell>.json``, and its metrics (``metrics/<metric>.py`` for each
per-layer one).  Nothing here lists a cell, a traffic kind or a metric:
adding one is adding files and entries."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list
    root: Path            # the directory the cell's files were found in

    def driver(self):
        return load_module(self.root / "drivers" / f"{self.traffic['kind']}.py")

    def metric_reader(self, name: str):
        return load_module(self.root / "metrics" / f"{name}.py")


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A harness file imported by its path (names may hold dots)."""
    name = "benchmark_file_" + "_".join(path.with_suffix("").parts[-2:]) \
        .replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric with ``workloads`` is reported by those cells; without,
    an end-to-end metric by every cell, and a per-layer one by every cell
    that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load(cell: str, bench: Path | None = None, root: Path = HERE) -> Cell:
    """The cell named ``cell`` of ``bench`` (the repository's
    ``BENCHMARK.json``), its files under ``root``."""
    spec = _read(bench or REPO / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        names = ", ".join(w["name"] for w in spec["workloads"])
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json ({names})")
    e2e = [m for m in spec["end_to_end"] if _reports(m, cell, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _reports(m, cell, names)]
    return Cell(name=cell, chips=entry["chips"],
                config=_read(root / "configs" / f"{entry['config']}.json"),
                traffic=_read(root / "traffic" / f"{entry['traffic']}.json"),
                limits=_read(root / "limits" / f"{cell}.json"),
                end_to_end=e2e, per_layer=layer, root=root)
