"""Reverse-KL variational inference by the plain reference: the ELBO of a
flow on a standard normal base, sampling with the flow's log-density, and
Adam (Kingma & Ba 2015, as `torch.optim.Adam` and optax state it).

``family`` is a reference module (`nsf`, `realnvp`), ``target`` a target
module (``target_<name>``); a configuration names both.
"""

from __future__ import annotations

import importlib
import math

import torch

from .nets import branches
from .precision import dtype_of


def modules(cfg: dict):
    """(the family's reference module, the target's log-density)."""
    family = importlib.import_module(f"{__package__}.{cfg['family']}")
    tgt = dict(cfg["target"])
    target = importlib.import_module(
        f"{__package__}.target_{tgt.pop('name').lower()}")
    return family, lambda y: target.log_prob(y, **tgt)


def base_log_prob(x: torch.Tensor) -> torch.Tensor:
    """log N(x; 0, I)."""
    return -0.5 * (x ** 2).sum(dim=-1) - 0.5 * x.shape[-1] * math.log(
        2 * math.pi)


def sample_and_log_prob(weights, x, cfg, precision):
    """(y, log q(y)) for base draws x: y = T(x), log q0(x) - log|det J|."""
    family, _ = modules(cfg)
    y, ld = family.forward_and_log_det(weights, x, cfg, precision)
    return y, base_log_prob(x) - ld


def elbo(weights, x, cfg, precision):
    """mean over the draws of log p(T(x)) - log q0(x) + log|det J(x)|."""
    family, logp = modules(cfg)
    y, ld = family.forward_and_log_det(weights, x, cfg, precision)
    return (logp(y) - base_log_prob(x) + ld).mean()


def cast(weights: dict, precision: str, requires_grad=False) -> dict:
    dt = dtype_of(precision)
    return {k: v.detach().to(dt, copy=True).requires_grad_(requires_grad)
            for k, v in weights.items()}


def adam_step(p: dict, m: dict, v: dict, t: int, x, cfg: dict,
              precision: str):
    """Step t of Adam on -ELBO at weights p with moments m, v (zero at
    t = 1) on draws x: (loss, gradient, the weights' change, the new m and
    v), in the precision's dtype. In float64, each leaky ReLU takes the
    branch that the same step in float32 takes (`nets.branches`): a
    pre-activation within rounding of 0 is a kink, where float32 and
    float64 would otherwise part by the jump of the slope (PERF.md)."""
    opt = cfg["optimizer"]
    lr, (b1, b2), eps = opt["lr"], opt["betas"], opt["eps"]
    p = cast(p, precision, requires_grad=True)
    x = x.to(dtype_of(precision))
    if precision == "float64":
        # the judge takes each leaky ReLU's branch as float32 takes it
        with torch.no_grad(), branches() as taken:
            elbo(cast(p, "float32"), x.float(), cfg, "float32")
        with branches(taken):
            loss = -elbo(p, x, cfg, precision)
    else:
        loss = -elbo(p, x, cfg, precision)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    m2, v2, delta = {}, {}, {}
    with torch.no_grad():
        for k, g in grads.items():
            m2[k] = b1 * m[k].to(g.dtype) + (1 - b1) * g
            v2[k] = b2 * v[k].to(g.dtype) + (1 - b2) * g * g
            delta[k] = -lr / c1 * m2[k] / (v2[k].sqrt() / math.sqrt(c2) + eps)
    return float(loss.detach()), grads, delta, m2, v2


def train(weights: dict, draws, cfg: dict, precision: str,
          keep=None) -> dict:
    """Adam steps on -ELBO from ``weights``, one a batch of ``draws``, in
    the precision given: each step's loss, and the weights and moments
    after each step t in ``keep`` (all, if None) under ``p[t]``, ``m[t]``,
    ``v[t]`` (t = 0: before the first)."""
    dt = dtype_of(precision)
    p = cast(weights, precision)
    m = {k: torch.zeros_like(w) for k, w in p.items()}
    v = {k: torch.zeros_like(w) for k, w in p.items()}
    out = {"losses": [], "p": {0: p}, "m": {0: m}, "v": {0: v}}
    for t, x in enumerate(draws, start=1):
        loss, _, delta, m, v = adam_step(p, m, v, t, x, cfg, precision)
        p = {k: (w + delta[k]).to(dt) for k, w in p.items()}
        out["losses"].append(loss)
        if keep is None or t in keep:
            out["p"][t], out["m"][t], out["v"][t] = p, m, v
    return out
