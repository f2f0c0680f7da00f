"""The reference's training updates, followed from the benchmark's draws.

Each update is the reference's (``ppo_stage1.py``): ``horizon`` acting
steps of every robot (policy forward, Gaussian sample from the given
standard-normal noise, env step with the given reset sample), the
bootstrap value, GAE, advantage normalization over the rollout, the
arena-major (A, N, T) flatten, and the PPO epochs in the given order.
"""
from __future__ import annotations

import torch

from . import env, policy, ppo
from .world import World


def rollout(world: World, model: dict, p: dict, st: env.State, horizon: int,
            noise, resets):
    a, n = st.pose.shape[:2]
    flat = lambda x: x.reshape(a * n, *x.shape[2:])
    keys = ("scans", "goal", "speed", "action", "logprob", "value",
            "reward", "done", "valid", "reached", "crashed")
    traj = {k: [] for k in keys}
    with torch.no_grad():
        for t in range(horizon):
            scans, goal, speed = env.obs(st)
            value, mean, logstd = policy.forward(p, model, flat(scans),
                                                 flat(goal), flat(speed))
            raw = mean + torch.exp(logstd) * noise[t]
            traj["scans"].append(scans)
            traj["goal"].append(goal)
            traj["speed"].append(speed)
            traj["action"].append(raw.reshape(a, n, 2))
            traj["logprob"].append(policy.log_density(raw, mean, logstd)
                                   .reshape(a, n))
            traj["value"].append(value.reshape(a, n))
            st, reward, done, info = env.step(world, st, raw.reshape(a, n, 2),
                                              *resets[t])
            traj["reward"].append(reward)
            traj["done"].append(done)
            for k in ("valid", "reached", "crashed"):
                traj[k].append(info[k])
        scans, goal, speed = env.obs(st)
        last = policy.forward(p, model, flat(scans), flat(goal),
                              flat(speed))[0][:, 0]
    return st, {k: torch.stack(v) for k, v in traj.items()}, last


def batch(traj: dict, last, gamma: float, lam: float) -> dict:
    t, a, n = traj["reward"].shape
    e = a * n
    flat_e = lambda x: x.reshape(t, e)
    targets, advs = ppo.gae(flat_e(traj["reward"]), flat_e(traj["value"]),
                            last, flat_e(traj["done"]).float(), gamma, lam)
    advs = ppo.normalize(advs)
    flat_m = lambda x: x.movedim(0, 2).reshape(t * e, *x.shape[3:])
    flat_te = lambda x: x.T.reshape(t * e)
    return {"scans": flat_m(traj["scans"]), "goal": flat_m(traj["goal"]),
            "speed": flat_m(traj["speed"]), "action": flat_m(traj["action"]),
            "logprob": flat_m(traj["logprob"])[:, None],
            "target": flat_te(targets)[:, None],
            "adv": flat_te(advs)[:, None],
            "weight": flat_m(traj["valid"]).float()}


def follow(config: dict, world: World, ppo_cfg: dict, params0: dict,
           start, updates) -> dict:
    """``len(updates)`` updates from ``params0`` and the arenas reset to
    ``start`` = (pose, goal); each entry of ``updates`` is (noise (T, E,
    2), resets (T pairs), perms).  Returns each update's loss of its
    first minibatch (its first optimizer step) and its mean loss, the
    first minibatch's gradients, the parameters after the last update,
    and each rollout's counts of ended episodes, goals and crashes."""
    model = config["model"]
    p = {k: v.detach().clone().requires_grad_() for k, v in params0.items()}
    adam = ppo.Adam(p, ppo_cfg["learning_rate"], **ppo_cfg["adam"])
    st = env.reset(world, *start)
    out = {"loss": [], "mean_loss": [], "counts": []}
    first = {}
    for noise, resets, perms in updates:
        st, traj, last = rollout(world, model, p, st, ppo_cfg["horizon"],
                                 noise, resets)
        b = batch(traj, last, ppo_cfg["gamma"], ppo_cfg["lam"])
        out["counts"].append([int((traj["done"] & traj["valid"]).sum()),
                              int(traj["reached"].sum()),
                              int(traj["crashed"].sum())])
        del traj
        mean_loss, parts = ppo.update(p, adam, model, ppo_cfg, b, perms,
                                      None if first else first.update)
        del b
        out["loss"].append(float(parts[0, 0]))
        out["mean_loss"].append(float(mean_loss))
    out["first_grad"] = first
    out["params"] = {k: v.detach() for k, v in p.items()}
    return out
