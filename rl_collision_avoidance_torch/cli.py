"""Command-line entry points of the port (counterpart of
``rl_collision_avoidance_tpu/cli.py``).  Stage-1 training only, so far::

    python -m rl_collision_avoidance_torch.cli train-stage1 --updates 5 --arenas 32

Runs on the CUDA card (``--device cpu`` for the plain PyTorch path).  Logs
through ``utils/metrics.MetricLogger`` into ``--log-dir`` (default
``log/<hostname>``) and writes the final params there as a JAX-format npz
(``--out`` to put it elsewhere), which ``--warm-start`` and the JAX
package's ``load_params_npz`` both read.
"""
from __future__ import annotations

import argparse
import os

import torch


def _add_stage1(p):
    p.add_argument("--arenas", type=int, default=1,
                   help="world replicas (default 1, the reference's one "
                        "world)")
    p.add_argument("--updates", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--warm-start", type=str, default=None,
                   help="params npz (JAX save_params_npz format) to start "
                        "from (curriculum transfer, ppo_stage2.py:194-200)")
    p.add_argument("--logstd-min", type=float, default=None,
                   help="floor for the policy logstd, projected after every "
                        "optimizer step (default: none, as the reference)")
    p.add_argument("--world", type=str, default=None,
                   help="override the stage's world (testing; the preset "
                        "picks stage1)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="override the PPO minibatch size (default: the "
                        "stage preset scaled by the arena count)")
    p.add_argument("--out", type=str, default=None,
                   help="where to write the final params npz (default: "
                        "<log dir>/stage1_params.npz)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")


def train_stage1(args) -> str:
    """Run stage-1 training as ``args`` say; returns the params npz path."""
    from .train import TrainConfig, Trainer
    from .utils.metrics import MetricLogger
    from .utils.params import (jax_params_to_torch, load_jax_npz,
                               save_params_npz, torch_to_jax_params)

    cfg = TrainConfig.stage1(n_arenas=args.arenas, seed=args.seed,
                             max_updates=args.updates)
    if args.world is not None:
        cfg.world = args.world
    if args.batch_size is not None:
        cfg.ppo = cfg.ppo._replace(batch_size=args.batch_size)
    if args.logstd_min is not None:
        cfg.ppo = cfg.ppo._replace(logstd_min=args.logstd_min)
    trainer = Trainer(cfg, device=args.device)
    logger = MetricLogger(args.log_dir)
    state = trainer.init_state()
    if args.warm_start:
        sd = jax_params_to_torch(load_jax_npz(args.warm_start))
        with torch.no_grad():
            state.policy.load_state_dict(sd)
    state = trainer.train(state, updates=args.updates,
                          log_fn=logger.log_update)
    out = args.out or os.path.join(logger.log_dir, "stage1_params.npz")
    save_params_npz(out, torch_to_jax_params(state.policy.state_dict()))
    print(f"wrote {out}", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="rl_collision_avoidance_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    _add_stage1(sub.add_parser("train-stage1",
                               help="train stage 1 (random rink)"))
    args = p.parse_args(argv)
    if args.cmd == "train-stage1":
        train_stage1(args)


if __name__ == "__main__":
    main()
