"""Command-line entry points of the port (counterpart of
``rl_collision_avoidance_tpu/cli.py``): the curriculum and its eval::

    python -m rl_collision_avoidance_torch.cli train-stage1 --updates 5 --arenas 32
    python -m rl_collision_avoidance_torch.cli train-stage2 \
        --warm-start results/stage1_params.npz --updates 2 --arenas 16
    python -m rl_collision_avoidance_torch.cli train-circle \
        --warm-start results/stage2_params.npz --updates 2 --arenas 16
    python -m rl_collision_avoidance_torch.cli circle-test \
        --params results/circle_ft_params.npz --arenas 32 --pose-noise 0.1
    python -m rl_collision_avoidance_torch.cli train-stage1 \
        --world stage1_rect --updates 5 --arenas 32
    python -m rl_collision_avoidance_torch.cli circle-test \
        --params results/circle_ft_params.npz --footprint rect
    python -m rl_collision_avoidance_torch.cli bench --train --arenas 32

Runs on the CUDA card (``--device cpu`` for the plain PyTorch path).  The
training commands log through ``utils/metrics.MetricLogger`` into
``--log-dir`` (default ``log/<hostname>``) and write the final params there
as a JAX-format npz named after the stage (``--out`` to put it elsewhere),
which ``--warm-start`` and the JAX package's ``load_params_npz`` both read.
``--bf16`` and ``--obs-bf16`` select the mixed precision of the JAX
command's flags of the same names.  With ``--checkpoint-dir`` they save the full train state every 20 updates
under ``<dir>/<stage>`` and ``--resume`` continues from the newest one
(unlike the JAX command, no full-state checkpoint is written by default).
``circle-test`` prints its metrics as one JSON line, as the JAX command
does, and ``bench`` runs ``bench.py`` with the arguments that follow it.
``--profile DIR`` traces updates 2 to 4 (``Trainer.train``).

Multi-process training: run the same command once a rank, with
``--coordinator IP:PORT`` (rank 0's address), ``--num-processes`` and this
rank's ``--process-id``.  Each rank takes its share of ``--arenas`` (by
default one arena a rank), rank r the card r modulo the host's cards,
through NCCL (gloo with ``--device cpu``).  Only rank 0 writes the logs and
the params npz; ``--checkpoint-dir`` and ``--resume`` are refused with more
than one process, as the JAX command writes no full-state checkpoint
then::

    python -m rl_collision_avoidance_torch.cli train-stage1 --arenas 64 \
        --coordinator 10.0.0.1:29500 --num-processes 2 --process-id 0
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

#: Subcommand -> the stage name of its TrainConfig preset.
STAGES = {"train-stage1": "stage1", "train-stage2": "stage2",
          "train-circle": "circle_ft"}


def _add_train(p):
    p.add_argument("--arenas", type=int, default=None,
                   help="world replicas over all ranks (default: one a "
                        "rank; the reference trains one world)")
    p.add_argument("--updates", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="save the full train state every 20 updates under "
                        "<dir>/<stage> (default: none)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint under "
                        "--checkpoint-dir, if there is one")
    p.add_argument("--warm-start", type=str, default=None,
                   help="params npz (JAX save_params_npz format) to start "
                        "from (curriculum transfer, ppo_stage2.py:194-200)")
    p.add_argument("--logstd-min", type=float, default=None,
                   help="floor for the policy logstd, projected after every "
                        "optimizer step (default: none for stages 1 and 2, "
                        "-2.0 for the circle fine-tune)")
    p.add_argument("--world", type=str, default=None,
                   help="override the stage's world (testing; the preset "
                        "picks its parity world)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="override the PPO minibatch size (default: the "
                        "stage preset scaled by the arena count)")
    p.add_argument("--out", type=str, default=None,
                   help="where to write the final params npz (default: "
                        "<log dir>/<stage>_params.npz)")
    p.add_argument("--bf16", action="store_true",
                   help="mixed-precision training: bfloat16 policy "
                        "activations and products (the trunk kernels' bf16 "
                        "mode), float32 params and Adam state")
    p.add_argument("--obs-bf16", action="store_true",
                   help="store the lidar scan history and the rollout "
                        "buffer's scans in bfloat16 (halves the largest "
                        "training tensor; ~1-2 mm quantization at 6 m)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; with "
                        "--coordinator, card process-id modulo the cards)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of updates 2-4 into "
                        "DIR (one file a rank)")
    # Multi-process launch (torch.distributed): the same command on every
    # rank with its own --process-id, as the JAX command's flags.
    p.add_argument("--coordinator", type=str, default=None,
                   metavar="IP:PORT",
                   help="rank 0's reachable address; omit for one process")
    p.add_argument("--num-processes", type=int, default=None,
                   help="the number of ranks launched")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in [0, num-processes)")


def _add_circle(p):
    p.add_argument("--params", type=str, default=None,
                   help="params npz (JAX save_params_npz format); a "
                        "random-init policy if omitted")
    p.add_argument("--max-steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--arenas", type=int, default=1,
                   help="replicas of the scenario (with --pose-noise: a "
                        "robustness study with mean and std across arenas)")
    p.add_argument("--pose-noise", type=float, default=0.0,
                   help="uniform per-robot initial-pose jitter in meters "
                        "(arena 0 always stays the exact reference scenario)")
    p.add_argument("--footprint", choices=["disc", "rect"], default="disc",
                   help="robot footprint: disc (the default) or rect, "
                        "Stage's exact 0.44 x 0.38 m box for collision and "
                        "lidar silhouettes (results/circle_eval_rect.json)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")


def train_config(stage: str, args):
    """The ``TrainConfig`` of the training ``stage`` ("stage1", "stage2" or
    "circle_ft") as ``args`` say."""
    from .train.trainer import PRESETS

    from .parallel import world_size

    cfg = PRESETS[stage](
        n_arenas=args.arenas or world_size(), seed=args.seed,
        max_updates=args.updates,
        policy_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        obs_store_dtype=torch.bfloat16 if args.obs_bf16 else None)
    if args.world is not None:
        cfg.world = args.world
    if args.batch_size is not None:
        cfg.ppo = cfg.ppo._replace(batch_size=args.batch_size)
    if args.logstd_min is not None:
        cfg.ppo = cfg.ppo._replace(logstd_min=args.logstd_min)
    return cfg


def train(stage: str, args) -> str | None:
    """Run the training ``stage`` ("stage1", "stage2" or "circle_ft") as
    ``args`` say, as one rank of ``--num-processes`` when there is a
    ``--coordinator``; returns the params npz path (None on ranks other
    than 0, which write nothing)."""
    from .parallel import setup_distributed, teardown

    if args.resume and args.checkpoint_dir is None:
        raise SystemExit("--resume needs --checkpoint-dir")
    if (args.num_processes or 1) > 1 and (args.checkpoint_dir or args.resume):
        raise SystemExit("--checkpoint-dir and --resume are single-process: "
                         "the full train state is not saved across ranks")
    # before any other CUDA use: the rank takes its card here
    device = setup_distributed(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
    try:
        return _train(stage, args, device or args.device)
    finally:
        teardown()


def _train(stage: str, args, device) -> str | None:
    from .parallel import rank
    from .train import Trainer
    from .utils.checkpoint import CheckpointManager
    from .utils.metrics import MetricLogger
    from .utils.params import (jax_params_to_torch, load_jax_npz,
                               save_params_npz, torch_to_jax_params)

    cfg = train_config(stage, args)
    trainer = Trainer(cfg, device=device)
    rank0 = rank() == 0
    logger = MetricLogger(args.log_dir) if rank0 else None
    ckpt = (CheckpointManager(os.path.join(args.checkpoint_dir, stage))
            if args.checkpoint_dir is not None else None)
    latest = ckpt.latest_step() if args.resume else None
    if latest is not None:
        state = trainer.load_state_dict(ckpt.restore(latest, trainer.device))
        print(f"resumed from {ckpt.directory} at update {latest}", flush=True)
    else:
        state = trainer.init_state()
        if args.warm_start:
            sd = jax_params_to_torch(load_jax_npz(args.warm_start))
            with torch.no_grad():
                state.policy.load_state_dict(sd)
    state = trainer.train(state, updates=args.updates,
                          log_fn=logger.log_update if rank0 else None,
                          checkpoint_manager=ckpt, profile_dir=args.profile)
    if not rank0:
        return None
    out = args.out or os.path.join(logger.log_dir, f"{stage}_params.npz")
    save_params_npz(out, torch_to_jax_params(state.policy.state_dict()))
    print(f"wrote {out}", flush=True)
    return out


def circle_test(args) -> dict:
    """The circle-50 eval as ``args`` say; prints and returns the metrics."""
    import dataclasses

    from .eval import run_circle_eval
    from .models import CNNPolicy, load_policy
    from .utils.device import resolve_device
    from .worlds import circle

    if args.params:
        policy = load_policy(args.params, device=args.device)
    else:
        # The reference exits without a checkpoint (circle_test.py:116-118);
        # as the JAX command, evaluate a random policy, but say so.
        print("warning: no --params given, evaluating a random policy",
              file=sys.stderr)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            policy = CNNPolicy()
        policy = policy.to(resolve_device(args.device)).eval()
    spec = dataclasses.replace(circle(), footprint=args.footprint)
    metrics = run_circle_eval(policy, spec, max_steps=args.max_steps,
                              seed=args.seed, n_arenas=args.arenas,
                              pose_noise=args.pose_noise)
    print(json.dumps(metrics), flush=True)
    return metrics


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rl_collision_avoidance_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    for cmd, what in (("train-stage1", "train stage 1 (random rink)"),
                      ("train-stage2", "train stage 2 (structured map)"),
                      ("train-circle", "fine-tune on the jittered 50-robot "
                                       "circle swap (warm-start from stage-2 "
                                       "params)")):
        _add_train(sub.add_parser(cmd, help=what))
    _add_circle(sub.add_parser("circle-test",
                               help="50-robot circle-swap evaluation"))
    sub.add_parser("bench", add_help=False,
                   help="the benchmarks (bench.py; its own arguments follow)")
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["bench"]:
        from . import bench

        return bench.main(argv[1:])
    args = parser().parse_args(argv)
    if args.cmd == "circle-test":
        circle_test(args)
    else:
        train(STAGES[args.cmd], args)


if __name__ == "__main__":
    main()
