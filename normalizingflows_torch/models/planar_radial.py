"""Planar and radial flows (Rezende & Mohamed 2015); counterpart of
`jl_tpu/models/planar_radial.py` (reference
`src/flows/planar_radial.jl:21-29,52-60`).

Planar: T(x) = x + û·tanh(wᵀx + b), with û = u + ((softplus(wᵀu) − 1 −
wᵀu)/‖w‖²)·w, so that wᵀû = softplus(wᵀu) − 1 > −1 and T is invertible.

Radial: T(x) = x + β·(x − z₀)/(α + r), r = ‖x − z₀‖, with α = softplus(α̂)
and β = −α + softplus(β̂) ≥ −α.

Neither inverse has a closed form: each is a scalar monotone root find
(`ops/solvers.py`), whose gradient is the implicit-function one.
``planarflow``/``radialflow`` build one `Repeated` of their layers, the JAX
``scan=True`` layout; a `Chain` of the layers builds its ``scan=False``
layout.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.solvers import solve_monotone
from ..utils.device import resolve_device
from .bijector import Bijector, stack_bijectors
from .distributions import DiagNormal, Distribution, TransformedDistribution
from .flows import create_flow

__all__ = ["PlanarLayer", "RadialLayer", "planarflow", "radialflow"]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as `jax.nn.softplus` computes it (torch's softplus
    returns x past a threshold)."""
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def _normal(generator, shape, dtype, device) -> torch.Tensor:
    """Standard-normal draws made on the generator's device, then moved,
    so one seed gives the same layer on every device."""
    z = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device)
    return z.to(resolve_device(device))


class PlanarLayer(Bijector):
    """T(x) = x + û·tanh(wᵀx + b); ``u``, ``w`` (dim,), ``b`` ()."""

    def __init__(self, u: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.u, self.w, self.b = (nn.Parameter(u), nn.Parameter(w),
                                  nn.Parameter(b))

    @staticmethod
    def make(generator: torch.Generator, dim: int, dtype=torch.float32,
             device=None) -> "PlanarLayer":
        """Standard-normal u, w and b, as Bijectors.jl initialises them."""
        return PlanarLayer(*(_normal(generator, shape, dtype, device)
                             for shape in ((dim,), (dim,), ())))

    def _u_hat(self):
        wu = self.w @ self.u
        m = _softplus(wu) - 1.0  # wᵀû > −1
        return self.u + (m - wu) / self.w.square().sum() * self.w, m

    def forward_and_log_det(self, x):
        u_hat, wu_hat = self._u_hat()
        h = torch.tanh(x @ self.w + self.b)
        y = x + h[..., None] * u_hat
        # |det J| = |1 + tanh′(a)·wᵀû|
        return y, torch.log(torch.abs(1.0 + (1.0 - h.square()) * wu_hat))

    def inverse_and_log_det(self, y):
        u_hat, c = self._u_hat()
        rhs = y @ self.w + self.b  # = a + c·tanh(a); solve for a

        def f(a):
            return a + c * torch.tanh(a) - rhs

        # a = rhs − c·tanh(a), so a lies in [rhs − |c|, rhs + |c|]
        a = solve_monotone(f, rhs - c.abs(), rhs + c.abs())
        h = torch.tanh(a)
        x = y - h[..., None] * u_hat
        return x, -torch.log(torch.abs(1.0 + (1.0 - h.square()) * c))


class RadialLayer(Bijector):
    """T(x) = x + β·(x − z₀)/(α + ‖x − z₀‖); ``alpha_raw``, ``beta_raw``
    (), ``z0`` (dim,)."""

    def __init__(self, alpha_raw: torch.Tensor, beta_raw: torch.Tensor,
                 z0: torch.Tensor):
        super().__init__()
        self.alpha_raw = nn.Parameter(alpha_raw)
        self.beta_raw = nn.Parameter(beta_raw)
        self.z0 = nn.Parameter(z0)

    @staticmethod
    def make(generator: torch.Generator, dim: int, dtype=torch.float32,
             device=None) -> "RadialLayer":
        return RadialLayer(*(_normal(generator, shape, dtype, device)
                             for shape in ((), (), (dim,))))

    def _alpha_beta(self):
        alpha = _softplus(self.alpha_raw)
        return alpha, -alpha + _softplus(self.beta_raw)

    @staticmethod
    def _log_det(beta, h, r, d):
        # J = (1+βh)I + βh′(r)(x−z₀)(x−z₀)ᵀ/r with h = 1/(α+r), h′ = −h²:
        # det = (1+βh)^{d−1}·(1 + βh − βh²r)
        return ((d - 1) * torch.log1p(beta * h)
                + torch.log1p(beta * h - beta * h.square() * r))

    def forward_and_log_det(self, x):
        alpha, beta = self._alpha_beta()
        diff = x - self.z0
        r = diff.square().sum(dim=-1).sqrt()
        h = 1.0 / (alpha + r)
        y = x + (beta * h)[..., None] * diff
        return y, self._log_det(beta, h, r, x.shape[-1])

    def inverse_and_log_det(self, y):
        alpha, beta = self._alpha_beta()
        diff = y - self.z0
        R = diff.square().sum(dim=-1).sqrt()

        def f(r):
            return r + beta * r / (alpha + r) - R

        # r·(1 + β/(α+r)) = R is increasing in r for β > −α; the bracket is
        # [R−β, R] for β ≥ 0 and [R, R−β] for β < 0
        lo = (R - beta.clamp_min(0.0)).clamp_min(0.0)
        r = solve_monotone(f, lo, R + (-beta).clamp_min(0.0))
        scale = r / R.clamp_min(torch.finfo(y.dtype).tiny)
        x = self.z0 + scale[..., None] * diff
        return x, -self._log_det(beta, 1.0 / (alpha + r), r, y.shape[-1])


def _flow(make, generator, q0, nlayers, dtype, device):
    device = resolve_device(device)
    if isinstance(q0, int):
        q0 = DiagNormal.standard(q0, dtype, device)
    layers = [make(generator, q0.event_dim, dtype, device)
              for _ in range(nlayers)]
    if nlayers > 1:
        return create_flow([stack_bijectors(layers)], q0)
    return create_flow(layers, q0)


def planarflow(generator: torch.Generator, q0: Distribution | int,
               nlayers: int = 10, dtype=torch.float32,
               device=None) -> TransformedDistribution:
    """``nlayers`` planar layers on ``q0`` (an int: the standard normal of
    that dimension) as one `Repeated` (reference
    `src/flows/planar_radial.jl:21-29`), on ``device`` (None: the card)."""
    return _flow(PlanarLayer.make, generator, q0, nlayers, dtype, device)


def radialflow(generator: torch.Generator, q0: Distribution | int,
               nlayers: int = 10, dtype=torch.float32,
               device=None) -> TransformedDistribution:
    """``nlayers`` radial layers on ``q0`` as one `Repeated` (reference
    `src/flows/planar_radial.jl:52-60`), on ``device`` (None: the card)."""
    return _flow(RadialLayer.make, generator, q0, nlayers, dtype, device)
