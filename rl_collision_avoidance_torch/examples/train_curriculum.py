"""The curriculum end to end: stage-1 training, stage 2 warm-started from the
best stage-1 params, then the circle-50 eval.

Counterpart of the JAX package's ``examples/train_curriculum.py``, the
reference's workflow (README.md:30-46: ``ppo_stage1`` -> ``ppo_stage2`` ->
``circle_test``) as three phases in one process, on the CUDA card unless
told otherwise::

    python -m rl_collision_avoidance_torch.examples.train_curriculum
    python -m rl_collision_avoidance_torch.examples.train_curriculum \
        --device cpu --updates 1 1 --arenas 1 1 1 --checkpoint-every 1 \
        --max-steps 5 --root /tmp/curriculum

Under the output root (``--root``, the working directory by default) each
stage logs to ``log/<stage>/`` (``utils/metrics.MetricLogger``), saves the
full train state every ``checkpoint_every`` updates with the best one by goal
share to ``checkpoints/<stage>/``, and writes the best params as
``checkpoints/<stage>_params.npz`` (the JAX ``save_params_npz`` format).  It
prints each stage's wall time with the device, then the eval of the stage-2
params as one JSON line: the deterministic ring, and the jittered study
(uniform +-1 m start noise) that stands in for the reference's asynchronous
timing.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from ..eval import run_circle_eval
from ..models import load_policy
from ..train import Trainer
from ..train.trainer import PRESETS
from ..utils.checkpoint import CheckpointManager
from ..utils.device import card_label, resolve_device
from ..utils.metrics import MetricLogger
from ..utils.params import (jax_params_to_torch, load_jax_npz,
                            save_params_npz, torch_to_jax_params)

#: Start-pose noise (m) of the eval's jittered study, as the JAX example's.
EVAL_NOISE = 1.0


def _where(device) -> str:
    return card_label() if device.type == "cuda" else str(device)


def train_stage(stage: str, updates: int, n_arenas: int, root: str,
                checkpoint_every: int, warm_start: str | None = None,
                device=None) -> str:
    """Train the preset ``stage`` ("stage1" or "stage2") for ``updates``
    updates of ``n_arenas`` arenas from random init or the params npz
    ``warm_start``; returns the path of the best checkpoint's params npz
    (the last update's when no checkpoint was due)."""
    tr = Trainer(PRESETS[stage](n_arenas=n_arenas), device=device)
    ckpt_dir = os.path.join(root, "checkpoints", stage)
    if os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        # its best checkpoint would compete with this run's
        raise FileExistsError(f"{ckpt_dir} holds an earlier run's "
                              f"checkpoints; give another output root")
    state = tr.init_state()
    if warm_start is not None:
        state.policy.load_state_dict(jax_params_to_torch(
            load_jax_npz(warm_start)))
    logger = MetricLogger(os.path.join(root, "log", stage))
    ckpt = CheckpointManager(ckpt_dir)
    t0 = time.perf_counter()
    state = tr.train(state, updates=updates, log_fn=logger.log_update,
                     checkpoint_manager=ckpt,
                     checkpoint_every=checkpoint_every)
    wall = time.perf_counter() - t0
    best = (ckpt.restore_best("cpu")["policy"]
            if ckpt.latest_step() is not None else state.policy.state_dict())
    out = os.path.join(root, "checkpoints", f"{stage}_params.npz")
    save_params_npz(out, torch_to_jax_params(best))
    print(f"{stage}: {updates} updates of {n_arenas} arenas in {wall:.2f} s "
          f"on {_where(tr.device)}; wrote {out}", flush=True)
    return out


def curriculum(updates=(1200, 800), n_arenas=(32, 16, 16),
               checkpoint_every: int = 25, max_steps: int = 2000,
               root: str = ".", device=None) -> dict:
    """Stage 1 for ``updates[0]`` updates of ``n_arenas[0]`` arenas, stage 2
    for ``updates[1]`` of ``n_arenas[1]`` from the best stage-1 params, then
    the eval of the best stage-2 params, up to ``max_steps`` steps: the
    deterministic ring and ``n_arenas[2]`` arenas at EVAL_NOISE.  Returns
    the two params paths and the eval's metrics."""
    device = resolve_device(device)
    s1 = train_stage("stage1", updates[0], n_arenas[0], root,
                     checkpoint_every, device=device)
    s2 = train_stage("stage2", updates[1], n_arenas[1], root,
                     checkpoint_every, warm_start=s1, device=device)
    policy = load_policy(s2, device=device)
    t0 = time.perf_counter()
    metrics = {
        "deterministic_symmetric": run_circle_eval(policy,
                                                   max_steps=max_steps),
        f"jitter_{EVAL_NOISE}m": run_circle_eval(
            policy, max_steps=max_steps, n_arenas=n_arenas[2],
            pose_noise=EVAL_NOISE)}
    print(f"eval: the ring and {n_arenas[2]} arenas at {EVAL_NOISE} m, up to "
          f"{max_steps} steps, in {time.perf_counter() - t0:.2f} s on "
          f"{_where(device)}", flush=True)
    print(json.dumps(metrics), flush=True)
    return {"stage1_params": s1, "stage2_params": s2, "eval": metrics}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--updates", type=int, nargs=2, default=(1200, 800),
                   metavar=("STAGE1", "STAGE2"))
    p.add_argument("--arenas", type=int, nargs=3, default=(32, 16, 16),
                   metavar=("STAGE1", "STAGE2", "EVAL"))
    p.add_argument("--checkpoint-every", type=int, default=25)
    p.add_argument("--max-steps", type=int, default=2000,
                   help="the eval's step limit")
    p.add_argument("--root", type=str, default=".",
                   help="output root for log/ and checkpoints/")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    return curriculum(a.updates, a.arenas, a.checkpoint_every, a.max_steps,
                      a.root, a.device)


if __name__ == "__main__":
    main()
