"""GAE, clipped PPO and Adam, plain (``model/ppo.py``)."""
from __future__ import annotations

import torch

from . import policy


def gae(rewards, values, last_value, dones, gamma: float, lam: float):
    """(T, E) rewards, values, dones and (E,) last value -> (targets,
    advantages), the backward recursion cut at ``done``."""
    not_done = 1.0 - dones.to(rewards.dtype)
    v_next = torch.cat([values[1:], last_value[None]], dim=0)
    targets = torch.empty_like(rewards)
    run = torch.zeros_like(last_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * v_next[t] * not_done[t] - values[t]
        run = delta + gamma * lam * not_done[t] * run
        targets[t] = run + values[t]
    return targets, targets - values


def normalize(advs):
    """Over the whole rollout, with the population std."""
    return (advs - advs.mean()) / advs.std(correction=0)


def loss(p: dict, model: dict, ppo: dict, mb: dict, wsum):
    """Returns (loss, policy loss, value loss, entropy) of one minibatch;
    transitions of weight 0 do not train."""
    value, mean, logstd = policy.forward(p, model, mb["scans"], mb["goal"],
                                         mb["speed"])
    ratio = torch.exp(policy.log_density(mb["action"], mean, logstd)
                      - mb["logprob"])
    surr1 = ratio * mb["adv"]
    surr2 = torch.clamp(ratio, 1.0 - ppo["clip_value"],
                        1.0 + ppo["clip_value"]) * mb["adv"]
    w = mb["weight"][:, None]
    policy_loss = -(torch.minimum(surr1, surr2) * w).sum() / wsum
    value_loss = ((value - mb["target"]) ** 2 * w).sum() / wsum
    ent = policy.entropy(logstd)
    total = (policy_loss + ppo["value_coeff"] * value_loss
             - ppo["coeff_entropy"] * ent)
    return total, policy_loss, value_loss, ent


class Adam:
    """Adam with bias correction (Kingma and Ba), in place on ``params``."""

    def __init__(self, params: dict, lr: float, beta1: float, beta2: float,
                 eps: float):
        self.params, self.lr, self.b1, self.b2, self.eps = (params, lr,
                                                            beta1, beta2, eps)
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = (1.0 - self.b2 ** self.t) ** 0.5
        for k, p in self.params.items():
            g = p.grad
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k].sqrt() / c2).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def update(p: dict, adam: Adam, model: dict, ppo: dict, batch: dict, perms,
           on_first_grad=None):
    """The PPO epochs over ``batch`` (dict of (M, ...) tensors) in the
    order ``perms`` (epochs, used); ``on_first_grad`` sees the gradients of
    the first minibatch.  Returns the mean loss over the minibatches and
    the (n, 4) losses of each."""
    bs = ppo["batch_size"]
    epochs = ppo["epochs"]
    idxs = perms.reshape(epochs, -1, bs)
    wsums = torch.clamp(batch["weight"][idxs].sum(-1), min=1.0)
    parts = []
    for e in range(epochs):
        for idx, wsum in zip(idxs[e], wsums[e]):
            mb = {k: v[idx] for k, v in batch.items()}
            out = loss(p, model, ppo, mb, wsum)
            for t in p.values():
                t.grad = None
            out[0].backward()
            if on_first_grad is not None and not parts:
                on_first_grad({k: t.grad.detach().clone()
                               for k, t in p.items()})
            adam.step()
            if ppo["logstd_min"] is not None:
                with torch.no_grad():
                    p["logstd"].clamp_(min=ppo["logstd_min"])
            parts.append(torch.stack([x.detach() for x in out]))
    parts = torch.stack(parts)
    return parts[:, 0].mean(), parts
