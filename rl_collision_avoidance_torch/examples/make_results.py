"""The results pipeline: the curriculum with jittered-circle checkpoint
selection in its fine-tune, the circle-50 sweep, and META.json.

Counterpart of the JAX package's ``examples/make_results.py`` and, with
``--bf16``, of ``examples/circle_ft_bf16.py``, on the CUDA card unless told
otherwise::

    python -m rl_collision_avoidance_torch.examples.make_results
    python -m rl_collision_avoidance_torch.examples.make_results \\
        --from-stage eval --params-dir results --eval-steps 3 \\
        --eval-arenas 2 --no-plots --device cpu --root /tmp/results
    python -m rl_collision_avoidance_torch.examples.make_results --bf16 \\
        --obs-bf16 --params-dir results

Stage 1 (32 arenas) from random init, stage 2 (16) from the stage-1 params,
the circle fine-tune (16) from the stage-2 params, then the sweep of the
fine-tuned policy.  Stage 1 and stage 2 keep their best checkpoint by goal
share (every 25 updates); the fine-tune keeps the params that score best on
the 50-robot circle under SELECT_NOISE of start jitter, evaluated every
``--select-every`` updates: in-task reach rate does not track circle
ability, so selection is made on the target task.  ``--from-stage`` reuses
the earlier stages' ``<stage>_params.npz`` from ``--params-dir``.

Everything goes under ``--root`` (``results_torch`` by default; never the
repository's ``results/``, the JAX package's evidence)::

    <stage>_params.npz           the kept params (JAX save_params_npz format)
    <stage>_metrics.csv          per-update training metrics
    circle_ft_circle_curve.csv   the fine-tune's selection evals
    circle_eval.json             the sweep (JAX's keys)
    META.json                    device, commit, phase records
    learning_curve.png, circle_demo.gif   unless --no-plots
    log/<stage>/, checkpoints/<stage>/    logs and full-state checkpoints

``--bf16`` runs the bf16 fine-tune alone instead (bf16 policy; with
``--obs-bf16`` bf16 scan storage too), from ``<params-dir>/stage2_params.npz``
with the same selection, into ``circle_ft_bf16[_f32obs]_{params.npz,
metrics.csv,eval.json}``.  The selection and the final evals run the
float32 master params in a float32 ``CNNPolicy``, as the JAX script does.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..eval import run_circle_eval
from ..models import CNNPolicy, load_policy
from ..utils.checkpoint import CheckpointManager
from ..utils.device import resolve_device
from ..utils.metrics import MetricLogger
from ..utils.params import save_params_npz, torch_to_jax_params
from ..worlds import circle
from .train_curriculum import best_params, start_stage, where

REPO = Path(__file__).resolve().parents[2]
#: The JAX package's committed results, which this pipeline never writes.
RESULTS = REPO / "results"
DEFAULT_ROOT = "results_torch"

STAGES = ("stage1", "stage2", "circle_ft", "eval")
#: Arenas of each training phase (results/META.json).
ARENAS = {"stage1": 32, "stage2": 16, "circle_ft": 16}
CHECKPOINT_EVERY = 25
SELECT_EVERY = 50     # fine-tune updates between circle selection evals
SELECT_NOISE = 0.3    # m of start-pose jitter in the selection eval
SELECT_ARENAS = 8
EVAL_STEPS = 3000     # step limit of every eval, the selection's too
EVAL_ARENAS = 32
EVAL_NOISES = (0.1, 0.3, 1.0)
BF16_NOISE = 0.3      # the bf16 fine-tune's jittered eval

NOTE = ("Rows evaluate the deterministic reference scenario (circle_test.py "
        "semantics: mean actions, fixed tables) plus jitter robustness "
        "studies perturbing initial poses by uniform +-sigma per axis (arena "
        "0 always unjittered). sigma=1 m is 2% of the 50 m crossing.")


def select_score(ev: dict) -> float:
    """Checkpoint-selection score on the jittered circle eval: success
    first, collisions as the tie-break once success saturates."""
    return ev["success_rate_mean"] - 0.002 * ev["collisions_mean"]


def _copy(policy) -> dict:
    return {k: v.detach().clone() for k, v in policy.state_dict().items()}


def select_on_circle(tr, state, updates: int, every: int, logger, ckpt,
                     steps: int = EVAL_STEPS):
    """``updates`` updates in chunks of ``every``, each followed by the
    circle eval (SELECT_ARENAS arenas at SELECT_NOISE, up to ``steps``
    steps) of the params in a float32 ``CNNPolicy``.  Starting from a score
    of -10 with the initial params, a chunk's params are kept only when
    they score strictly higher (a tie keeps the earlier ones).  Returns
    (kept state dict, curve rows, best score)."""
    judge = CNNPolicy(tr.spec.laser_frames, tr.spec.n_beams).to(tr.device)
    best_score, best = -10.0, _copy(state.policy)
    curve = []
    for done in range(0, updates, every):
        n = min(every, updates - done)
        state = tr.train(state, updates=n, log_fn=logger.log_update,
                         checkpoint_manager=ckpt,
                         checkpoint_every=CHECKPOINT_EVERY)
        judge.load_state_dict(state.policy.state_dict())
        ev = run_circle_eval(judge, max_steps=steps, n_arenas=SELECT_ARENAS,
                             pose_noise=SELECT_NOISE)
        score = select_score(ev)
        curve.append({"update": done + n,
                      "circle_success_mean": ev["success_rate_mean"],
                      "collisions_mean": ev["collisions_mean"]})
        print(f"  [select] update {done + n}: circle success "
              f"{ev['success_rate_mean']:.3f} coll "
              f"{ev['collisions_mean']:.1f} (best score "
              f"{max(best_score, score):.3f})", flush=True)
        if score > best_score:
            best_score, best = score, _copy(state.policy)
    return best, curve, best_score


def train(stage: str, updates: int, n_arenas: int, root: str,
          warm_start: str | None = None, circle_select_every: int = 0,
          device=None, name: str | None = None,
          select_steps: int = EVAL_STEPS, **cfg_kw) -> dict:
    """One curriculum phase of the preset ``stage`` (``cfg_kw`` passed on to
    it), written under ``root`` as ``name`` (``stage`` by default).

    Without ``circle_select_every`` it keeps the best checkpoint by goal
    share; with it, the params :func:`select_on_circle` keeps, and the
    selection evals go to ``<name>_circle_curve.csv``.  Writes
    ``<name>_params.npz`` and ``<name>_metrics.csv``; returns the phase
    record of the JAX script."""
    name = name or stage
    tr, state = start_stage(stage, n_arenas, warm_start, device, **cfg_kw)
    log_dir = os.path.join(root, "log", name)
    ckpt_dir = os.path.join(root, "checkpoints", name)
    for d in (log_dir, ckpt_dir):  # a fresh metrics.csv, no earlier best
        shutil.rmtree(d, ignore_errors=True)
    logger = MetricLogger(log_dir)
    ckpt = CheckpointManager(ckpt_dir)
    t0 = time.perf_counter()
    extra = {}
    if not circle_select_every:
        state = tr.train(state, updates=updates, log_fn=logger.log_update,
                         checkpoint_manager=ckpt,
                         checkpoint_every=CHECKPOINT_EVERY)
        best = best_params(ckpt, state)
    else:
        best, curve, best_score = select_on_circle(
            tr, state, updates, circle_select_every, logger, ckpt,
            select_steps)
        with open(os.path.join(root, f"{name}_circle_curve.csv"), "w",
                  newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(curve[0]))
            w.writeheader()
            w.writerows(curve)
        extra = {"circle_select_every": circle_select_every,
                 "circle_select_noise_m": SELECT_NOISE,
                 "circle_select_best_score": round(best_score, 4)}
    dt = time.perf_counter() - t0
    save_params_npz(os.path.join(root, f"{name}_params.npz"),
                    torch_to_jax_params(best))
    shutil.copy(os.path.join(log_dir, "metrics.csv"),
                os.path.join(root, f"{name}_metrics.csv"))
    print(f"{name}: {updates} updates in {dt:.1f} s on {where(tr.device)}",
          flush=True)
    cfg = tr.cfg
    return {"stage": stage, "updates": updates, "n_arenas": n_arenas,
            "wall_s": round(dt, 1), "horizon": cfg.horizon,
            "batch_size": cfg.ppo.batch_size, "epochs": cfg.ppo.epochs,
            **extra}


def circle_ft_bf16(updates: int, root: str, warm_start: str,
                   obs_bf16: bool = True, select_every: int = SELECT_EVERY,
                   eval_steps: int = EVAL_STEPS,
                   eval_arenas: int = EVAL_ARENAS, device=None,
                   select_steps: int = EVAL_STEPS) -> dict:
    """The circle fine-tune in bf16 mixed precision (bf16 policy; bf16 scan
    storage with ``obs_bf16``) from ``warm_start``, with the circle
    selection, then the kept params in a float32 ``CNNPolicy`` on the ring
    and ``eval_arenas`` arenas at BF16_NOISE, into
    ``circle_ft_bf16[_f32obs]_eval.json``.  Returns that dict, with the
    phase record under ``phase``."""
    name = "circle_ft_bf16" + ("" if obs_bf16 else "_f32obs")
    record = train("circle_ft", updates, ARENAS["circle_ft"], root,
                   warm_start, select_every, device, name, select_steps,
                   policy_dtype=torch.bfloat16,
                   obs_store_dtype=torch.bfloat16 if obs_bf16 else None)
    policy = load_policy(os.path.join(root, f"{name}_params.npz"),
                         device=resolve_device(device))
    out = {
        "note": ("circle_ft re-trained in bf16 mixed precision ("
                 + ("--bf16 --obs-bf16 equivalent" if obs_bf16
                    else "bf16 activations, f32 obs storage")
                 + "); compare circle_eval.json (f32 run)"),
        "deterministic": run_circle_eval(policy, max_steps=eval_steps),
        f"jitter_{BF16_NOISE}m": run_circle_eval(
            policy, max_steps=eval_steps, n_arenas=eval_arenas,
            pose_noise=BF16_NOISE)}
    with open(os.path.join(root, f"{name}_eval.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return {**out, "phase": record}


def evaluate(params: str, root: str, stage2_params: str | None = None,
             steps: int = EVAL_STEPS, arenas: int = EVAL_ARENAS,
             device=None, plots: bool = True) -> dict:
    """The circle-swap sweep of the fine-tuned ``params`` into
    ``<root>/circle_eval.json``: the deterministic ring, ``arenas`` arenas
    at each of EVAL_NOISES, 12 robots on the same ring, and with
    ``stage2_params`` the stage-2 policy's ring and 0.3 m rows; each up to
    ``steps`` steps.  With ``plots``, also the demo GIF."""
    policy = load_policy(params, device=resolve_device(device))
    t0 = time.perf_counter()
    out = {"policy": "circle_ft (stage-3 fine-tune, see META.json phases)",
           "note": NOTE,
           "deterministic": run_circle_eval(policy, max_steps=steps)}
    for noise in EVAL_NOISES:
        out[f"jitter_{noise}m"] = run_circle_eval(
            policy, max_steps=steps, n_arenas=arenas, pose_noise=noise)
    # 12 robots on the same 25 m ring: a count and spacing never trained on
    out["ring_12_robots"] = run_circle_eval(policy, spec=circle(n_robots=12),
                                            max_steps=steps)
    if stage2_params is not None:
        s2 = load_policy(stage2_params, device=policy.logstd.device)
        out["stage2_policy"] = {
            "deterministic": run_circle_eval(s2, max_steps=steps),
            "jitter_0.3m": run_circle_eval(s2, max_steps=steps,
                                           n_arenas=arenas, pose_noise=0.3)}
    out["eval_wall_s"] = round(time.perf_counter() - t0, 1)
    with open(os.path.join(root, "circle_eval.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: out[k] for k in ("deterministic", "jitter_0.3m")}),
          flush=True)
    if plots:
        render_circle_gif(policy, root)
    return out


def plot_curves(root: str) -> None:
    """Goal-reach rate and mean episode return against the update, from
    every ``<stage>_metrics.csv`` under ``root``, into
    ``learning_curve.png`` (matplotlib, imported here only)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for stage, color in (("stage1", "tab:blue"), ("stage2", "tab:orange"),
                         ("circle_ft", "tab:green"),
                         ("circle_ft_bf16", "tab:purple"),
                         ("circle_ft_bf16_f32obs", "tab:pink")):
        path = os.path.join(root, f"{stage}_metrics.csv")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            rows = [r for r in csv.DictReader(f)
                    if r.get("update", "").replace(".", "").isdigit()]
        upd = np.array([int(float(r["update"])) for r in rows])
        ep = np.maximum(np.array([float(r["episodes"]) for r in rows]), 1)
        reach = np.array([float(r["reached"]) for r in rows]) / ep
        ret = np.array([float(r["ep_return_sum"]) for r in rows]) / ep
        k = max(1, len(upd) // 50)
        smooth = lambda x: np.convolve(x, np.ones(k) / k, mode="valid")
        axes[0].plot(upd[k - 1:], smooth(reach), color=color, label=stage)
        axes[1].plot(upd[k - 1:], smooth(ret), color=color, label=stage)
    axes[0].set_xlabel("update")
    axes[0].set_ylabel("goal-reach rate")
    axes[0].set_ylim(0, 1)
    axes[1].set_xlabel("update")
    axes[1].set_ylabel("mean episode return")
    for ax in axes:
        ax.legend()
        ax.grid(alpha=0.3)
    fig.suptitle("PPO curriculum (stage1: 24 robots; stage2: 44; "
                 "circle_ft: 50)")
    fig.tight_layout()
    fig.savefig(os.path.join(root, "learning_curve.png"), dpi=120)
    plt.close(fig)


def render_circle_gif(policy, root: str, steps: int = 600,
                      every: int = 6) -> str:
    """The demo GIF of the deterministic ring (mean actions, clipped):
    ``steps`` steps, every ``every``-th a frame, into ``circle_demo.gif``
    (``utils/render.save_trajectory_gif``: matplotlib and PIL)."""
    from ..engine.env import Env
    from ..utils.render import save_trajectory_gif

    spec = circle()
    env = Env(spec, device=policy.logstd.device)
    state, obs = env.reset(1)
    goal, poses = state.goal[0].clone(), []
    n = spec.n_robots
    with torch.no_grad():
        for _ in range(steps):
            _, mean, _ = policy(obs.scans[0], obs.goal[0], obs.speed[0])
            act = torch.stack([mean[:, 0].clamp(0.0, 1.0),
                               mean[:, 1].clamp(-1.0, 1.0)], -1)
            state, obs, _, _, _ = env.step(state, act.reshape(1, n, 2))
            poses.append(state.pose[0].clone())
    return save_trajectory_gif(os.path.join(root, "circle_demo.gif"), spec,
                               torch.stack(poses)[::every], goal)


def git_commit() -> str:
    """HEAD of the checkout this package lies in, or "" outside a git
    checkout."""
    if not (REPO / ".git").exists():
        return ""
    try:
        proc = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                              capture_output=True, text=True, timeout=30,
                              check=False)
    except OSError:
        return ""
    return proc.stdout.strip()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true",
                   help="5 updates a stage, no circle selection, a 600-step "
                        "sweep over 2 arenas")
    p.add_argument("--stage1-updates", type=int, default=5000)
    p.add_argument("--stage2-updates", type=int, default=2500)
    p.add_argument("--circle-ft-updates", type=int, default=2000)
    p.add_argument("--from-stage", choices=STAGES, default="stage1",
                   help="skip earlier phases, reusing their "
                        "<stage>_params.npz from --params-dir")
    p.add_argument("--select-every", type=int, default=SELECT_EVERY,
                   help="fine-tune updates between circle selection evals")
    p.add_argument("--eval-steps", type=int, default=EVAL_STEPS,
                   help="step limit of the selection evals and the sweep")
    p.add_argument("--eval-arenas", type=int, default=EVAL_ARENAS)
    p.add_argument("--bf16", action="store_true",
                   help="run the bf16 fine-tune alone (circle_ft_bf16.py)")
    p.add_argument("--obs-bf16", action="store_true",
                   help="with --bf16: store the scans in bf16 too")
    p.add_argument("--no-plots", action="store_true",
                   help="no learning_curve.png and no circle_demo.gif")
    p.add_argument("--root", default=DEFAULT_ROOT, help="output directory")
    p.add_argument("--params-dir", default=None,
                   help="where reused stages' params are read (default: "
                        "--root)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    if a.obs_bf16 and not a.bf16:
        p.error("--obs-bf16 needs --bf16")
    root = os.path.abspath(a.root)
    if os.path.realpath(root) == os.path.realpath(RESULTS):
        p.error(f"{RESULTS} holds the JAX package's results; give another "
                f"--root")
    params_dir = a.params_dir or root
    if a.quick:
        a.stage1_updates = a.stage2_updates = a.circle_ft_updates = 5
        a.select_every, a.eval_steps, a.eval_arenas = 0, 600, 2
    device = resolve_device(a.device)
    os.makedirs(root, exist_ok=True)
    if a.bf16:
        return circle_ft_bf16(
            a.circle_ft_updates, root,
            os.path.join(params_dir, "stage2_params.npz"), a.obs_bf16,
            a.select_every, a.eval_steps, a.eval_arenas, device,
            a.eval_steps)

    meta = {"device": where(device), "git": git_commit(),
            "started_unix": time.time(), "phases": []}
    start = STAGES.index(a.from_stage)
    if start > 0:
        # the reused stages' records from the META.json beside their params
        prev_phases = []
        meta_path = os.path.join(params_dir, "META.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                prev_phases = [ph for ph in json.load(f).get("phases", [])
                               if ph.get("stage") in STAGES[:start]]
        meta["phases"].extend(prev_phases or [{"stage": "reused",
                                               "stages": list(
                                                   STAGES[:start])}])
        meta["reused_stages"] = list(STAGES[:start])
    src = lambda stage: os.path.join(root if STAGES.index(stage) >= start
                                     else params_dir, f"{stage}_params.npz")
    if start <= 0:
        meta["phases"].append(train("stage1", a.stage1_updates,
                                    ARENAS["stage1"], root, device=device))
    if start <= 1:
        meta["phases"].append(train(
            "stage2", a.stage2_updates, ARENAS["stage2"], root,
            warm_start=src("stage1"), device=device))
    if start <= 2:
        meta["phases"].append(train(
            "circle_ft", a.circle_ft_updates, ARENAS["circle_ft"], root,
            warm_start=src("stage2"), circle_select_every=a.select_every,
            device=device, select_steps=a.eval_steps))
    stage2 = src("stage2")
    evaluate(src("circle_ft"), root,
             stage2 if os.path.exists(stage2) else None, a.eval_steps,
             a.eval_arenas, device, plots=not a.no_plots)
    if not a.no_plots:
        plot_curves(root)
    meta["finished_unix"] = time.time()
    with open(os.path.join(root, "META.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


if __name__ == "__main__":
    main()
