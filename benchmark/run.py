"""Benchmark of the PyTorch/CUDA port on its card: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, the kernel library, which the first
run of a checkout builds into ``rl_collision_avoidance_torch/_build/``,
the cell's objects, its checked units and its warm-up) is timed from the
start of this script.  The window then runs the cell's units (training
updates or eval calls, ``drivers/<kind>.py``) until ``--seconds`` have
passed; the unit running at the deadline completes and counts.  With
``--trace 1`` a fixed amount of further work (the driver's
``TRACED_UNITS``) runs under torch.profiler and the per-layer metrics are
read from it (``metrics/<name>.py``).  Then the program is freed, the
plain reference (``reference/``) redoes the checked work, and each
compared number is printed with its limit.  The last line of standard
output is the result, as JSON.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One process with one CPU thread: the work is on the card, and the host
# thread that enqueues it should not share its core with a thread pool.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: Top-level modules no run may load: JAX and the JAX package this port
#: replaces.  Compared whole, so ``rl_collision_avoidance_torch`` is not one.
FORBIDDEN = ("jax", "jaxlib", "flax", "rl_collision_avoidance_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in modules} & set(FORBIDDEN))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def per_layer(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


class Context:
    """What a per-layer metric reads: the cell, the untraced window's
    tally and seconds, the trace and its units, and the mean number of
    wall segments a lidar beam tested in the traced work."""

    def __init__(self, cell, window, window_s, trace, traced, lidar_segments):
        self.cell, self.window, self.window_s = cell, window, window_s
        self.trace, self.traced = trace, traced
        self.lidar_segments = lidar_segments
        self.model = cell.config["model"]
        self.world = cell.config["worlds"][cell.traffic["world"]]
        self.robots = cell.traffic["arenas"] * self.world["n_robots"]


def run(cell, seed: int, seconds: float, trace: bool, device,
        policy_dtype=None) -> dict:
    """One run of ``cell`` on ``device``: the result's fields, and under
    ``checked`` each compared number with its limit."""
    import torch

    from benchmark import check, counts
    from benchmark import trace as tracing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kwargs = {} if policy_dtype is None else {"policy_dtype": policy_dtype}
    driver = cell.driver()
    session = driver.Session(cell, seed, device, **kwargs)
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - START
    records, ends, deadline = [], [t0], t0 + seconds
    while True:
        records.append(session.unit())
        ends.append(time.perf_counter())
        if ends[-1] >= deadline:
            break
    sync()
    t1 = time.perf_counter()
    window_s = t1 - t0
    tr = traced = segments = None
    if trace:
        n, poses = driver.TRACED_UNITS, []
        more, tr = tracing.record(lambda: [session.unit(poses)
                                           for _ in range(n)])
        traced = session.tally(more)
        segments = counts.CellSegments(
            cell.config["worlds"][cell.traffic["world"]]).mean(
                torch.cat([p.reshape(-1, 3) for p in poses])[:, :2]
                .cpu().numpy())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window = session.tally(records)
    check_t0 = time.perf_counter()
    readings = session.readings(records)
    correct, compared = check.judge(readings, cell.limits)
    ctx = Context(cell, window, window_s, tr, traced, segments)
    if trace:
        metrics = per_layer(cell, ctx)
    else:
        values = {"setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                values[m["name"]] = window["robot_steps"] / window_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": correct, "attempted": window["units"],
              "failed": window["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name()
                                  if cuda else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if trace:
        result["device"]["busy_s"] = tr.busy_us / 1e6
        result["device"]["window_s"] = tr.window_us / 1e6
        result["breakdown"] = {"device_ops": tr.op_seconds(),
                               "idle_gaps": tr.gap_seconds()}
    result["checked"] = compared
    result["_readings"] = readings
    result["_info"] = {"setup_s": setup_s, "setup_phases": session.phases,
                       "window_s": window_s,
                       "unit_s": [round(b - a, 4) for a, b in
                                  zip(ends, ends[1:])],
                       "window": window, "traced": traced,
                       "lidar_segments": segments,
                       "reduce_s": tr.reduce_s if tr else None,
                       "check_s": time.perf_counter() - check_t0}
    return result


def card_label() -> str:
    import subprocess

    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return (proc.stdout.strip() or proc.stderr.strip()).replace("\n", "; ")


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch

    from benchmark import check, spec

    cell = spec.load(args.workload)
    imported = time.perf_counter() - START
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"card: {card_label()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.cuda.init()
    context = time.perf_counter() - START
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    readings, info = result.pop("_readings"), result.pop("_info")
    info["setup_phases"] = {"imports": imported, "cuda_init": context,
                            **info["setup_phases"]}
    print("readings: " + json.dumps(readings, default=str), flush=True)
    print("info: " + json.dumps(info, default=str), flush=True)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    check.print_limits(result["checked"])
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
