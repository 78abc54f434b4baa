"""Hamiltonian flow: leapfrog bijector and momentum normalisation
(counterpart of `jl_tpu/models/hamiltonian.py`; the reference's demo
`example/demo_hamiltonian_flow.jl:27-147`, after Chen, Xu & Campbell,
"Bayesian inference via sparse Hamiltonian flows", NeurIPS 2022).

The flow lives on the joint space z = [x, ρ] ∈ ℝ^{2d} and targets
π(x)·N(ρ; 0, I) (`joint_logp`). `LeapFrog` runs L leapfrog steps with a
trainable per-dimension step size ε = exp(log ε); its inverse negates ε
and its log-det is zero (leapfrog is symplectic). The target's score
∇log π is part of the transform, so the ELBO's gradient differentiates
through it: first order through a closed-form score (`Funnel.score`), a
double backward through an autograd one (`Banana.score`).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from ..utils.device import resolve_device
from .bijector import (
    Bijector,
    Chain,
    Identity,
    Scale,
    Shift,
    Stacked,
    _zero_log_det,
    stack_bijectors,
)
from .distributions import DiagNormal, TransformedDistribution
from .flows import create_flow

__all__ = ["LeapFrog", "momentum_normalization_layer", "hamiltonian_flow",
           "joint_logp"]

_LOG_2PI = math.log(2.0 * math.pi)


class LeapFrog(Bijector):
    """L leapfrog steps on z = [x, ρ] with a trainable per-dimension
    ``log_eps`` (dim,), its only parameter (`@functor LeapFrog (logϵ,)`,
    `demo_hamiltonian_flow.jl:38`). ``score_fn`` (∇log π on (..., dim)) is
    a plain callable, not a submodule."""

    def __init__(self, log_eps: torch.Tensor, dim: int, L: int,
                 score_fn: Callable[[torch.Tensor], torch.Tensor]):
        super().__init__()
        self.log_eps = nn.Parameter(log_eps)
        self.dim, self.L, self.score_fn = int(dim), int(L), score_fn

    @staticmethod
    def make(dim: int, log_eps0: float, L: int, score_fn: Callable,
             dtype=torch.float32, device=None) -> "LeapFrog":
        """`LeapFrog(dim, logϵ, L, ∇logp)` (`demo_hamiltonian_flow.jl:
        40-43`): ``log_eps0`` on every dimension."""
        return LeapFrog(torch.full((dim,), float(log_eps0), dtype=dtype,
                                   device=resolve_device(device)),
                        dim, L, score_fn)

    def _steps(self, x, v, eps):
        """`demo_hamiltonian_flow.jl:50-61`: v += ε/2·∇logp(x);
        (L−1)×[x += ε·v; v += ε·∇logp(x)];
        x += ε·v; v += ε/2·∇logp(x)."""
        g = self.score_fn
        v = v + 0.5 * eps * g(x)
        for _ in range(self.L - 1):
            x = x + eps * v
            v = v + eps * g(x)
        x = x + eps * v
        v = v + 0.5 * eps * g(x)
        return x, v

    def _apply(self, z, eps):
        x, v = self._steps(z[..., :self.dim], z[..., self.dim:], eps)
        return torch.cat([x, v], dim=-1), _zero_log_det(z)

    def forward_and_log_det(self, z):
        return self._apply(z, torch.exp(self.log_eps))

    def inverse_and_log_det(self, z):
        return self._apply(z, -torch.exp(self.log_eps))


def momentum_normalization_layer(dim: int, dtype=torch.float32,
                                 device=None) -> Stacked:
    """Identity on the position, Scale then Shift on the momentum
    (`demo_hamiltonian_flow.jl:93-99`; scale 1, shift 0 at init)."""
    device = resolve_device(device)
    affine = Chain((Scale(torch.ones((dim,), dtype=dtype, device=device)),
                    Shift(torch.zeros((dim,), dtype=dtype, device=device))))
    return Stacked((Identity(), affine), [(0, dim), (dim, 2 * dim)])


def joint_logp(logp: Callable[[torch.Tensor], torch.Tensor],
               dim: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """``logp`` lifted to the joint (x, ρ) space: log π(x) + log N(ρ; 0, I)
    (`demo_hamiltonian_flow.jl:117-124`)."""

    def lp(z):
        lp_rho = (-0.5 * z[..., dim:].square().sum(dim=-1)
                  - 0.5 * dim * _LOG_2PI)
        return logp(z[..., :dim]) + lp_rho

    return lp


def hamiltonian_flow(
    dim: int,
    score_fn: Callable[[torch.Tensor], torch.Tensor],
    n_blocks: int = 15,
    L: int = 3,
    eps0: float = 0.05,
    dtype=torch.float32,
    device=None,
) -> TransformedDistribution:
    """The demo's Hamiltonian flow (`demo_hamiltonian_flow.jl:139-147`) on
    the 2·dim joint space: N(0, I) base, a trainable Scale then Shift, then
    ``n_blocks`` of [LeapFrog(L, ε₀), momentum normalisation] as one
    `Repeated` (the JAX ``scan=True`` layout; a `Chain` of the blocks
    builds ``scan=False``), on ``device`` (None: the card)."""
    device = resolve_device(device)
    base = DiagNormal.standard(2 * dim, dtype, device)
    layers: list[Bijector] = [
        Scale(torch.ones((2 * dim,), dtype=dtype, device=device)),
        Shift(torch.zeros((2 * dim,), dtype=dtype, device=device)),
    ]
    blocks = [Chain((LeapFrog.make(dim, math.log(eps0), L, score_fn, dtype,
                                   device),
                     momentum_normalization_layer(dim, dtype, device)))
              for _ in range(n_blocks)]
    if n_blocks > 1:
        layers.append(stack_bijectors(blocks))
    else:
        layers.extend(blocks)
    return create_flow(layers, base)
