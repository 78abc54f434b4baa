"""VI quality diagnostics: error bars, normalizing-constant estimates, ESS,
and two distances between sample sets.

Counterpart of `normalizingflows/jl_tpu/diagnostics.py`. With draws
y ~ q and log-weights log w = log p̃(y) − log q(y):

* ELBO = E_q[log w], with its standard error (ddof 1);
* log Ẑ = logsumexp(log w) − log n;
* ESS = (Σw)² / Σw², in log space; ESS/n → 1 iff q ≡ p on the support.

Where JAX takes a PRNG key these take a ``torch.Generator`` on the flow's
device. Each estimator is one batched forward pass of the flow; each
returns 0-dim tensors on the flow's device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .models.distributions import TransformedDistribution
from .objectives import elbo_single_sample

__all__ = ["FlowDiagnostics", "elbo_with_sem", "ess", "evaluate_flow",
           "grid_total_variation", "log_normalizer", "log_weights",
           "sliced_wasserstein2"]

LogDensity = Callable[[torch.Tensor], torch.Tensor]


def log_weights(generator: torch.Generator, flow: TransformedDistribution,
                logp: LogDensity, n_samples: int) -> torch.Tensor:
    """Per-sample importance log-weights ``log p̃(T(x)) − log q(T(x))`` on
    the forward path: ``log q(T(x)) = log q₀(x) − logdet``, no inverse."""
    xs = flow.base.sample(generator, (n_samples,))
    return elbo_single_sample(flow, logp, xs)


def _sem(lw: torch.Tensor) -> torch.Tensor:
    return lw.std(correction=1) / math.sqrt(lw.shape[0])


def _log_normalizer(lw: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(lw, dim=0) - math.log(lw.shape[0])


def _ess(lw: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    out = torch.exp(2.0 * torch.logsumexp(lw, dim=0)
                    - torch.logsumexp(2.0 * lw, dim=0))
    return out / lw.shape[0] if normalize else out


def elbo_with_sem(generator: torch.Generator, flow: TransformedDistribution,
                  logp: LogDensity, n_samples: int):
    """(ELBO Monte-Carlo estimate, its standard error)."""
    lw = log_weights(generator, flow, logp, n_samples)
    return lw.mean(), _sem(lw)


def log_normalizer(generator: torch.Generator,
                   flow: TransformedDistribution, logp: LogDensity,
                   n_samples: int) -> torch.Tensor:
    """Importance-sampling estimate of log Z of the unnormalized target:
    ``logsumexp(log w) − log n`` (→ 0 as q → p for a normalized target)."""
    return _log_normalizer(log_weights(generator, flow, logp, n_samples))


def ess(generator: torch.Generator, flow: TransformedDistribution,
        logp: LogDensity, n_samples: int,
        normalize: bool = True) -> torch.Tensor:
    """Effective sample size (Kong 1992) ``(Σw)²/Σw²`` of the
    self-normalized importance weights; ESS/n in (0, 1] with
    ``normalize``."""
    return _ess(log_weights(generator, flow, logp, n_samples), normalize)


class FlowDiagnostics(NamedTuple):
    elbo: torch.Tensor
    elbo_sem: torch.Tensor
    log_normalizer: torch.Tensor
    ess: torch.Tensor        # normalized, in (0, 1]
    n_samples: int


def evaluate_flow(generator: torch.Generator, flow: TransformedDistribution,
                  logp: LogDensity, n_samples: int = 4096
                  ) -> FlowDiagnostics:
    """One-call quality report from one batched forward pass: ESS/n near 1
    and log Ẑ near the known log Z indicate a good fit; ELBO ± SEM is the
    bound with its error bar."""
    lw = log_weights(generator, flow, logp, n_samples)
    return FlowDiagnostics(elbo=lw.mean(), elbo_sem=_sem(lw),
                           log_normalizer=_log_normalizer(lw), ess=_ess(lw),
                           n_samples=n_samples)


def _sliced_w2(xs: torch.Tensor, ys: torch.Tensor,
               theta: torch.Tensor) -> torch.Tensor:
    """Sliced W₂ of ``xs`` and ``ys`` over the directions ``theta``
    (n_proj, dim), normalized here."""
    theta = theta / torch.linalg.vector_norm(theta, dim=-1, keepdim=True)
    px = torch.sort(xs @ theta.T, dim=0).values  # (n, n_proj)
    py = torch.sort(ys @ theta.T, dim=0).values
    return torch.sqrt(torch.mean(torch.square(px - py)))


def sliced_wasserstein2(generator: torch.Generator, xs: torch.Tensor,
                        ys: torch.Tensor,
                        n_projections: int = 128) -> torch.Tensor:
    """Sliced 2-Wasserstein distance between two equal-size sample sets:
    the root mean over ``n_projections`` uniform unit directions θ of the
    squared L2 distance between the sorted projections θᵀxs and θᵀys.
    Detects shape mismatch that per-coordinate moments miss, and scales
    past 2-D. In the data's units."""
    if xs.shape != ys.shape:
        raise ValueError(f"sample sets must match: {tuple(xs.shape)} vs "
                         f"{tuple(ys.shape)}")
    theta = torch.randn((n_projections, xs.shape[-1]), generator=generator,
                        dtype=xs.dtype, device=xs.device)
    return _sliced_w2(xs, ys, theta)


def grid_total_variation(xs: torch.Tensor, ys: torch.Tensor, bins: int = 64,
                         lims: tuple | None = None) -> torch.Tensor:
    """Total-variation distance ``0.5·Σ|p̂ − q̂|`` between 2-D histograms
    of two sample sets on a ``bins×bins`` grid over ``lims`` (xmin, xmax,
    ymin, ymax; default the joint bounding box). In [0, 1]; its Monte-Carlo
    floor for identical distributions is O(√(bins²/n)). A sample's bin is
    truncated toward zero and clipped to the grid, as in the JAX package."""
    if xs.shape[-1] != 2 or ys.shape[-1] != 2:
        raise ValueError("grid_total_variation is 2-D only")
    if lims is None:
        both = torch.cat([xs, ys], dim=0)
        lo, hi = both.amin(dim=0), both.amax(dim=0)
    else:
        lo = torch.tensor([lims[0], lims[2]], dtype=xs.dtype,
                          device=xs.device)
        hi = torch.tensor([lims[1], lims[3]], dtype=xs.dtype,
                          device=xs.device)

    def hist(s):
        ij = ((s - lo) / (hi - lo + 1e-12) * bins).to(torch.int32)
        ij = ij.clamp(0, bins - 1).long()
        flat = ij[:, 0] * bins + ij[:, 1]
        h = torch.zeros((bins * bins,), dtype=xs.dtype, device=xs.device)
        h.index_add_(0, flat, torch.ones_like(flat, dtype=xs.dtype))
        return h / s.shape[0]

    return 0.5 * torch.sum(torch.abs(hist(xs) - hist(ys)))
