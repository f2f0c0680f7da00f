"""Readings of a cell's compared numbers for the limits: sound runs, the
control and planted faults, many seeds in one process, on the card.

    python3 benchmark/calibrate.py --workload stage1-train --sound 12 \
        --control 3 --faults 3 --out chiprun_out/calibrate.jsonl

The control is the program's own bf16 mode (``policy_dtype=bfloat16``:
the trunk kernels' bf16 products and a bf16 tail), the next precision
below the configuration's float32.  Faults are those of ``faults.py``
that need a run (an update that returns its state unchanged reads 1 on
the change by its measure, and needs none).  Training reads the checked
updates alone; the eval runs ``--calls`` calls and compares the traffic's
sample of their arenas.  Each reading is one JSON line of ``--out``;
standard output ends with each number's largest sound reading and the
least reading of the control and of each fault.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: Seeds of the readings step by this from ``--first-seed``.
SEED_STEP = 7919


def reading(cell, seed: int, device, variant: str, calls: int) -> dict:
    import torch

    from benchmark import faults

    kind = cell.traffic["kind"]
    dtype = torch.bfloat16 if variant == "control" else torch.float32
    plant = (faults.FAULTS[kind][variant]() if variant in faults.FAULTS[kind]
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    with plant:
        session = cell.driver().Session(cell, seed, device, dtype)
        records = [session.unit() for _ in range(calls if kind == "eval"
                                                  else 0)]
        out = session.readings(records)
    out.update(seed=seed, variant=variant, seconds=time.perf_counter() - t0)
    del session
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--first-seed", type=int, default=2_900_000_000)
    ap.add_argument("--variants", nargs="*",
                    help="read only these (sound, control, fault names)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    from benchmark import faults, spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load(args.workload)
    kind = cell.traffic["kind"]
    plan = [("sound", args.sound), ("control", args.control)]
    plan += [(f, args.faults) for f in faults.FAULTS[kind]
             if not (kind == "train" and f == "unchanged")]
    if kind == "eval":
        plan = plan[:2]          # eval faults are the CPU tests'
    if args.variants:
        plan = [(v, n) for v, n in plan if v in args.variants]
    rows = []
    with open(args.out, "a") as f:
        for variant, n in plan:
            for i in range(n):
                row = reading(cell, args.first_seed + SEED_STEP * i, "cuda",
                              variant, args.calls)
                row["workload"] = args.workload
                rows.append(row)
                f.write(json.dumps(row, default=str) + "\n")
                f.flush()
                print(json.dumps({k: row[k] for k in row
                                  if k not in ("sampled",)}, default=str),
                      flush=True)
    for name in cell.limits:
        sound = [r[name] for r in rows if r["variant"] == "sound"]
        print(f"{name}: sound max {max(sound, default=None)}; " + "; ".join(
            f"{v} min {min(r[name] for r in rows if r['variant'] == v)}"
            for v, _ in plan if v != "sound"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
