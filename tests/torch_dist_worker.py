"""One rank of the port's multi-process tests, run as its own process:

    python tests/torch_dist_worker.py MODE RANK WORLD INIT_URL IN OUT

It joins a ``torch.distributed`` group of WORLD ranks through INIT_URL
(``file://`` or ``tcp://``), reads its inputs from the ``torch.save`` file
IN, does MODE, and writes what it found to OUT (``torch.save``), with the
names of any JAX, flax, PIL or JAX-package module it loaded: it imports
the port alone, so every run also holds the port to the no-JAX rule in a
fresh process.  The tests start the ranks with :func:`run_ranks`.  Modes:

- ``ppo``: ``ppo_update`` on this rank's shard of IN's batch
  (gloo, CPU);
- ``train``: one ``Trainer.train_step`` on mini with this rank's slice of
  IN's env state, noise, reset draws and minibatch orders (gloo, CPU);
- ``nccl_twice``: set up an NCCL group whose ranks share one card, which
  must raise; the error's text is written.
"""
import os
import subprocess
import sys
from pathlib import Path

import torch

FORBIDDEN = ("jax", "flax", "PIL", "rl_collision_avoidance_tpu")
ROOT = Path(__file__).resolve().parents[1]


def run_ranks(mode: str, inp, tmp, world: int = 2, env=None,
              timeout: float = 600) -> list[dict]:
    """Run MODE on ``world`` ranks, each its own process, joined through a
    file store in the directory ``tmp`` (no port to race for), with the
    inputs ``inp``; returns the ranks' outputs.  Every rank must exit 0
    and load nothing of JAX.  ``env`` adds to the environment (by default
    the ranks see no card)."""
    tmp = Path(tmp)
    in_path, url = tmp / f"{mode}_in.pt", f"file://{tmp}/{mode}_store"
    torch.save(inp, in_path)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join([str(ROOT),
                                          os.environ.get("PYTHONPATH", "")]),
           **(env or {})}
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(world), url,
         str(in_path), str(tmp / f"{mode}_out{r}.pt")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {mode} failed:\n{log[-3000:]}"
    outs = [torch.load(tmp / f"{mode}_out{r}.pt") for r in range(world)]
    for r, out in enumerate(outs):
        assert not out["forbidden"], (r, out["forbidden"])
    return outs


def ppo(rank: int, world: int, inp: dict) -> dict:
    from rl_collision_avoidance_torch.algo.ppo import (Batch, PPOConfig,
                                                      ppo_update)
    from rl_collision_avoidance_torch.models import CNNPolicy

    cfg = PPOConfig(**inp["ppo"])
    policy = CNNPolicy(*inp["batch"]["scans"].shape[1:])
    policy.load_state_dict(inp["params"])
    optimizer = torch.optim.Adam(policy.parameters(), lr=cfg.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    m = inp["batch"]["scans"].shape[0] // world
    batch = Batch(*(inp["batch"][f][rank * m:(rank + 1) * m]
                    for f in Batch._fields))
    out = ppo_update(policy, optimizer, batch, cfg, inp["perms"][rank])
    return {"params": policy.state_dict(),
            "metrics": {k: float(out[k]) for k in ("policy_loss",
                                                   "value_loss", "entropy")}}


def train(rank: int, world: int, inp: dict) -> dict:
    from rl_collision_avoidance_torch.algo.ppo import PPOConfig
    from rl_collision_avoidance_torch.parallel import arena_range
    from rl_collision_avoidance_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(world="mini", n_arenas=inp["arenas"],
                      horizon=inp["noise"].shape[0],
                      ppo=PPOConfig(**inp["ppo"]))
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state()
    state.policy.load_state_dict(inp["params"])
    lo, hi = arena_range(cfg.n_arenas)
    n = tr.spec.n_robots
    env_state, _ = tr.env.reset(hi - lo, inp["pose"][lo:hi],
                                inp["goal"][lo:hi])
    env_state.step = inp["steps"][lo:hi]
    state.env_state = env_state
    resets = [(p[lo:hi], g[lo:hi]) for p, g in inp["resets"]]
    state, metrics = tr.train_step(state, inp["noise"][:, lo * n:hi * n],
                                   resets, inp["perms"][rank])
    return {"params": state.policy.state_dict(), "metrics": metrics}


def nccl_twice(rank: int, world: int, url: str) -> dict:
    from rl_collision_avoidance_torch.parallel import setup_distributed

    try:
        setup_distributed(url, world, rank)
    except RuntimeError as e:
        return {"error": str(e)}
    return {"error": None}


def main():
    mode, rank, world, url, in_path, out_path = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    if mode == "nccl_twice":
        out = nccl_twice(rank, world, url)
    else:
        from rl_collision_avoidance_torch.parallel import (setup_distributed,
                                                           teardown)

        inp = torch.load(in_path)
        setup_distributed(url, world, rank, device="cpu")
        try:
            out = {"ppo": ppo, "train": train}[mode](rank, world, inp)
        finally:
            teardown()
    out["forbidden"] = sorted(m for m in sys.modules
                              if m.split(".")[0] in FORBIDDEN)
    torch.save(out, out_path)


if __name__ == "__main__":
    main()
