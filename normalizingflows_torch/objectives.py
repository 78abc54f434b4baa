"""Reverse-KL ELBO objectives.

Counterpart of the ELBO part of `normalizingflows/jl_tpu/objectives.py`
(reference `src/objectives/elbo.jl`). Any callable
``vo(input, flow, *args) -> scalar`` can be passed to `train_flow`; higher
is better and the trainer negates it into a loss. Where JAX takes a PRNG
``key`` these take a ``torch.Generator`` on the flow's device.
"""

from __future__ import annotations

from typing import Callable

import torch

from .models.distributions import TransformedDistribution

__all__ = [
    "elbo", "elbo_batch", "elbo_from_samples", "elbo_single_sample",
    "presample_base",
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
