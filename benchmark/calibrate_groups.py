"""``calibrate.py`` for a cell of the traffic kind ``train_groups``
(``stage2-train``): readings of its compared numbers from sound runs, the
control and planted faults, many seeds in one process, on the card.

    python3 benchmark/calibrate_groups.py --workload stage2-train \
        --sound 24 --control 3 --faults 3 --out chiprun_out/calibrate.jsonl

The faults are ``faults.FAULTS["train"]`` and three of the stage-2 step:
``rolled_lidar`` (every frame turned by one beam), ``group_of_one`` (each
robot resets alone, as in stage 1, instead of waiting for its group) and
``heading_drift`` (the heading integrates the turn rate 5% too fast, and
the newest frame is cast at that heading).  The
output is ``calibrate.py``'s: one JSON line of ``--out`` a reading, and
each number's largest sound reading and the least reading of the control
and of each fault.
"""
import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import faults  # noqa: E402
from benchmark.calibrate import SEED_STEP  # noqa: E402

#: ``heading_drift``'s excess share of the turn a step.
HEADING_DRIFT = 0.05


def rolled_lidar():
    import torch

    from rl_collision_avoidance_torch.ops import lidar_cuda

    def make(lidar_obs):
        def rolled(*args, **kwargs):
            return torch.roll(lidar_obs(*args, **kwargs), 1, dims=-1)
        return rolled
    return faults._patched(lidar_cuda, "lidar_obs", make)


def group_of_one():
    import numpy as np

    from rl_collision_avoidance_torch.train import trainer

    def make(get_world):
        def world(name):
            spec = get_world(name)
            if spec.group_id is None:
                return spec
            return dataclasses.replace(
                spec, group_id=np.arange(spec.n_robots, dtype=np.int32))
        return world
    return faults._patched(trainer, "get_world", make)


def heading_drift():
    from rl_collision_avoidance_torch.engine.env import Env

    def make(env_step):
        def step(self, state, *args, **kwargs):
            new, _, reward, done, info = env_step(self, state, *args,
                                                  **kwargs)
            pose = new.pose.clone()
            pose[..., 2] += HEADING_DRIFT * self.spec.dt * new.speed[..., 1]
            # the newest frame cast at the drifted pose, as a step whose
            # integration drifts would cast it
            hist = new.scan_hist.clone()
            hist[:, :, -1] = self.scan_obs(pose)
            new = dataclasses.replace(new, pose=pose, scan_hist=hist)
            return new, self.obs(new), reward, done, info
        return step
    return faults._patched(Env, "step", make)


FAULTS = {**faults.FAULTS["train"], "rolled_lidar": rolled_lidar,
          "group_of_one": group_of_one, "heading_drift": heading_drift}


def reading(cell, seed: int, variant: str) -> dict:
    import torch

    dtype = torch.bfloat16 if variant == "control" else torch.float32
    t0 = time.perf_counter()
    plant = FAULTS[variant]() if variant in FAULTS else \
        contextlib.nullcontext()
    with plant:
        session = cell.driver().Session(cell, seed, "cuda", dtype)
        out = session.readings([])
    out.update(seed=seed, variant=variant, seconds=time.perf_counter() - t0)
    del session
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="stage2-train")
    ap.add_argument("--sound", type=int, default=24)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_900_000_000)
    ap.add_argument("--variants", nargs="*",
                    help="read only these (sound, control, fault names)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    from benchmark import spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load(args.workload)
    plan = [("sound", args.sound), ("control", args.control)]
    plan += [(f, args.faults) for f in FAULTS]
    if args.variants:
        plan = [(v, n) for v, n in plan if v in args.variants]
    rows = []
    with open(args.out, "a") as f:
        for variant, n in plan:
            for i in range(n):
                row = reading(cell, args.first_seed + SEED_STEP * i, variant)
                row["workload"] = args.workload
                rows.append(row)
                f.write(json.dumps(row, default=str) + "\n")
                f.flush()
                print(json.dumps(row, default=str), flush=True)
    for name in cell.limits:
        sound = [r[name] for r in rows if r["variant"] == "sound"]
        print(f"{name}: sound max {max(sound, default=None)}; " + "; ".join(
            f"{v} min {min(r[name] for r in rows if r['variant'] == v)}"
            for v, _ in plan if v != "sound"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
