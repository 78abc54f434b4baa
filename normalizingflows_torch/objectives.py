"""Variational objectives: reverse-KL ELBO (plain, batched, STL,
importance-weighted), the forward-KL log-likelihood, and the tempered
(annealing) lift of an ELBO.

Counterpart of `normalizingflows/jl_tpu/objectives.py` (reference
`src/objectives/elbo.jl`, `src/objectives/loglikelihood.jl`). Any
callable ``vo(input, flow, *args) -> scalar`` can be passed to
`train_flow`; higher is better and the trainer negates it into a loss.
Where JAX takes a PRNG ``key`` these take a ``torch.Generator`` on the
flow's device.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from .models.distributions import TransformedDistribution

__all__ = [
    "elbo", "elbo_batch", "elbo_from_samples", "elbo_iw",
    "elbo_single_sample", "elbo_stl", "loglikelihood", "presample_base",
    "tempered",
]

LogDensity = Callable[[torch.Tensor], torch.Tensor]


def elbo_single_sample(flow: TransformedDistribution, logp: LogDensity,
                       x: torch.Tensor) -> torch.Tensor:
    """ELBO terms ``logp(T(x)) − log q₀(x) + log|det J_T(x)|`` for base
    draws ``x`` (one draw (dim,) or a batch (..., dim))."""
    y, log_det = flow.bijector.forward_and_log_det(x)
    return logp(y) - flow.base.log_prob(x) + log_det


def elbo(generator: torch.Generator, flow: TransformedDistribution,
         logp: LogDensity, n_samples: int) -> torch.Tensor:
    """Monte-Carlo reverse-KL ELBO (reference `elbo.jl:36-46`). The JAX
    package maps the single-sample estimate over the draws with `vmap`;
    every bijector here takes leading batch dimensions, so the map is the
    batched traversal."""
    xs = flow.base.sample(generator, (n_samples,))
    return elbo_single_sample(flow, logp, xs).mean()


def elbo_batch(generator: torch.Generator, flow: TransformedDistribution,
               logp: LogDensity, n_samples: int) -> torch.Tensor:
    """Batched ELBO: one transform of the whole (n, d) sample block
    (reference `elbo.jl:89-99`)."""
    return elbo_from_samples(flow.base.sample(generator, (n_samples,)), flow,
                             logp)


class _LogProb(nn.Module):
    """``flow.log_prob`` as a module's forward, for `functional_call`."""

    def __init__(self, flow: TransformedDistribution):
        super().__init__()
        self.flow = flow

    def forward(self, y):
        return self.flow.log_prob(y)


def elbo_stl(generator: torch.Generator, flow: TransformedDistribution,
             logp: LogDensity, n_samples: int) -> torch.Tensor:
    """Sticking-the-landing ELBO (Roeder, Wu & Duvenaud 2017). The value of
    `elbo_batch`; its gradient keeps only the path derivative: ``log q(y)``
    is evaluated through the inverse of a gradient-stopped copy of the flow
    (its parameters enter detached), so the gradient reaches the
    parameters through the draws ``y`` alone."""
    xs = flow.base.sample(generator, (n_samples,))
    ys, _ = flow.bijector.forward_and_log_det(xs)
    stopped = {f"flow.{n}": p.detach() for n, p in flow.named_parameters()}
    log_q = torch.func.functional_call(_LogProb(flow), stopped, (ys,))
    return (logp(ys) - log_q).mean()


def elbo_iw(generator: torch.Generator, flow: TransformedDistribution,
            logp: LogDensity, n_samples: int,
            n_particles: int = 8) -> torch.Tensor:
    """Importance-weighted ELBO (Burda, Grosse & Salakhutdinov 2016):
    ``mean_n [logsumexp_K log w − log K]`` with ``log w = logp(T(x)) −
    log q(T(x))`` over ``n_particles`` draws per sample, one batched
    traversal of the (K, n, d) block."""
    xs = flow.base.sample(generator, (n_particles, n_samples))
    log_w = elbo_single_sample(flow, logp, xs)  # (K, n)
    return (torch.logsumexp(log_w, dim=0) - math.log(n_particles)).mean()


def loglikelihood(flow: TransformedDistribution,
                  xs: torch.Tensor) -> torch.Tensor:
    """Forward-KL / maximum-likelihood objective: the mean log-density of
    data ``xs`` (n, d) under the flow (reference
    `src/objectives/loglikelihood.jl:18-33`, its unused ``rng`` dropped),
    through the inverse and its log-det."""
    return flow.log_prob(xs).mean()


def elbo_from_samples(xs: torch.Tensor, flow: TransformedDistribution,
                      logp: LogDensity) -> torch.Tensor:
    """Batched ELBO over already drawn base samples ``xs`` (n, d): pair with
    `presample_base` as `train_flow`'s ``scan_inputs``."""
    return elbo_single_sample(flow, logp, xs).mean()


def presample_base(n_samples: int):
    """``scan_inputs`` factory for `train_flow`: draws every step's
    ``n_samples`` base samples for a whole chunk in one call, shaped
    (chunk, n, d); step i's objective gets ``draws[i]``."""

    def gen(generator, flow, chunk: int):
        return flow.base.sample(generator, (chunk, n_samples))

    return gen


def tempered(objective: Callable[..., torch.Tensor],
             ref_logp: LogDensity) -> Callable[..., torch.Tensor]:
    """Lift an ELBO-style objective onto the geometric annealing path:
    ``vo(inp, flow, logp, n, beta)`` is ``objective(inp, flow, lp, n)``
    for the tempered density ``lp(x) = (1−β)·log q_ref(x) + β·log p(x)``.
    At β=0 the target is the reference (typically the flow's base), at
    β=1 the true target (`train.train_flow_annealed` walks β between
    them). ``beta`` may be a 0-dim tensor on the flow's device, filled in
    place between segments, so that one captured step serves them all."""

    def vo(inp, flow, logp, n, beta):
        def lp(x):
            return (1.0 - beta) * ref_logp(x) + beta * logp(x)

        return objective(inp, flow, lp, n)

    return vo
