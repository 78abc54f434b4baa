"""Synthetic target distributions (counterpart of `jl_tpu/models/targets.py`).

The reference's `example/targets/` zoo: `Banana`, `Funnel` (with its
analytic score), `GaussianMixture` with its 4-component `Cross`, and
`WarpedGauss`. Every `log_prob` takes ``(..., dim)`` batches, and every
`sample` is exact, so they serve as ground truth for the parity tests.
Scalar parameters are Python floats; the mixture's arrays are buffers on
the target's device, so a graphed step copies nothing from the host.

`score` (∇ log p) is closed form for `Funnel`; for the others it is the
autograd gradient of `log_prob` (the JAX package's `jax.grad`), with a
graph when ``x`` has one, so a training step can differentiate through it
(the Hamiltonian flow's leapfrog) and sampling under `torch.no_grad` can
call it too.
"""

from __future__ import annotations

import math

import torch

from ..utils.device import resolve_device
from .distributions import Distribution

__all__ = ["Banana", "Funnel", "Cross", "WarpedGauss", "GaussianMixture"]

_LOG_2PI = math.log(2.0 * math.pi)


def _autograd_score(log_prob, x: torch.Tensor) -> torch.Tensor:
    """∇ₓ Σ log_prob(x). Differentiable (``create_graph``) where ``x``
    requires grad; otherwise taken on a detached copy and returned
    detached, also under `torch.no_grad`."""
    graph = x.requires_grad
    with torch.enable_grad():
        xg = x if graph else x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(log_prob(xg).sum(), xg,
                                   create_graph=graph)
    return g


class Banana(Distribution):
    """Banana distribution of Roberts & Rosenthal (2009).

    N(0, diag(var, 1, …, 1)) pushed through the unit-Jacobian map
    ``ϕ(x) = (x₁, x₂ − b·x₁² + var·b, x₃, …)`` (reference
    `example/targets/banana.jl:53-83`). Banana(2, 1, 100) is the "hard"
    demo target, Banana(2, 1, 10) the "easy" one."""

    def __init__(self, dim: int, b: float = 1.0, var: float = 10.0):
        super().__init__()
        if dim < 2:
            raise ValueError("Banana dim must be >= 2")
        self.dim, self.b, self.var = int(dim), float(b), float(var)

    @property
    def event_dim(self) -> int:
        return self.dim

    def sample(self, generator, sample_shape=(), dtype=torch.float32):
        """Exact draws, made on the generator's device."""
        z = torch.randn(tuple(sample_shape) + (self.dim,),
                        generator=generator, dtype=dtype,
                        device=generator.device)
        z0 = z[..., 0] * math.sqrt(self.var)
        y1 = z[..., 1] - self.b * z0.square() + self.var * self.b
        return torch.cat([z0[..., None], y1[..., None], z[..., 2:]], dim=-1)

    def log_prob(self, x):
        # ϕ⁻¹: z₂ = x₂ + b x₁² − var·b; then the Gaussian log-density
        z1 = x[..., 1] + self.b * x[..., 0].square() - self.var * self.b
        log_z = 0.5 * (self.dim * _LOG_2PI + math.log(self.var))
        quad = (x[..., 0].square() / self.var + z1.square()
                + x[..., 2:].square().sum(dim=-1))
        return -log_z - 0.5 * quad

    def score(self, x):
        return _autograd_score(self.log_prob, x)


class Funnel(Distribution):
    """Neal's funnel: x₁ ~ N(μ, σ²), x_{2:d} | x₁ ~ N(0, exp(x₁) I)
    (reference `example/targets/neal_funnel.jl:26-72`, defaults μ=0, σ=9;
    the Hamiltonian flow demo takes Funnel(2, −8, 5) and its score)."""

    def __init__(self, dim: int, mu: float = 0.0, sigma: float = 9.0):
        super().__init__()
        if dim < 2:
            raise ValueError("Funnel dim must be >= 2")
        self.dim, self.mu, self.sigma = int(dim), float(mu), float(sigma)

    @property
    def event_dim(self) -> int:
        return self.dim

    def sample(self, generator, sample_shape=(), dtype=torch.float32):
        """Exact draws, made on the generator's device."""
        z = torch.randn(tuple(sample_shape) + (self.dim,),
                        generator=generator, dtype=dtype,
                        device=generator.device)
        x1 = self.mu + self.sigma * z[..., :1]
        return torch.cat([x1, z[..., 1:] * torch.exp(0.5 * x1)], dim=-1)

    def log_prob(self, x):
        x1, rest = x[..., 0], x[..., 1:]
        lp1 = (-0.5 * (((x1 - self.mu) / self.sigma).square() + _LOG_2PI)
               - math.log(self.sigma))
        # x_{2:d} | x₁ ~ N(0, exp(x₁) I)
        lp2 = -0.5 * (rest.square().sum(dim=-1) * torch.exp(-x1)
                      + (self.dim - 1) * (x1 + _LOG_2PI))
        return lp1 + lp2

    def score(self, x):
        """Analytic ∇ log p (`neal_funnel.jl:63-72`): with a = e^{−x₁},
        ∂₁ = (μ−x₁)/σ² − (d−1)/2 + a·Σx²/2; ∂ᵢ = −a·xᵢ."""
        x1, rest = x[..., 0], x[..., 1:]
        a = torch.exp(-x1)
        g1 = ((self.mu - x1) / self.sigma ** 2 - 0.5 * (self.dim - 1)
              + 0.5 * a * rest.square().sum(dim=-1))
        return torch.cat([g1[..., None], -a[..., None] * rest], dim=-1)


class GaussianMixture(Distribution):
    """Diagonal-covariance Gaussian mixture: ``locs`` (k, d), ``scales``
    (k, d), ``weights`` (k,), kept as buffers on ``device`` (None: the
    card) in the dtype they come in."""

    def __init__(self, locs, scales, weights, device=None):
        super().__init__()
        device = resolve_device(device)
        for name, value in (("locs", locs), ("scales", scales),
                            ("weights", weights)):
            self.register_buffer(name, torch.as_tensor(value, device=device))

    @property
    def event_dim(self) -> int:
        return self.locs.shape[-1]

    def sample(self, generator, sample_shape=()):
        """Exact draws on the mixture's device (the generator's too)."""
        shape = tuple(sample_shape)
        n = math.prod(shape)
        comp = torch.multinomial(self.weights, n, replacement=True,
                                 generator=generator).reshape(shape)
        eps = torch.randn(shape + (self.event_dim,), generator=generator,
                          dtype=self.locs.dtype, device=self.locs.device)
        return self.locs[comp] + self.scales[comp] * eps

    def log_prob(self, x):
        # each component's diagonal-normal log-density, then logsumexp
        z = (x[..., None, :] - self.locs) / self.scales  # (..., k, d)
        comp = (-0.5 * z.square().sum(dim=-1)
                - torch.log(self.scales).sum(dim=-1)
                - 0.5 * self.event_dim * _LOG_2PI)
        return torch.logsumexp(comp + torch.log(self.weights), dim=-1)

    def score(self, x):
        return _autograd_score(self.log_prob, x)


def Cross(mu: float = 2.0, sigma: float = 0.15, dtype=torch.float32,
          device=None) -> GaussianMixture:
    """Cross-shaped 4-component 2-D mixture with the reference CODE's means
    (0, μ), (−μ, 1), (μ, 1), (0, −μ) (`example/targets/cross.jl:31-38`;
    its docstring says (±μ, 0) for the horizontal arms)."""
    locs = torch.tensor([[0.0, mu], [-mu, 1.0], [mu, 1.0], [0.0, -mu]],
                        dtype=dtype)
    scales = torch.tensor([[sigma, 1.0], [1.0, sigma], [1.0, sigma],
                           [sigma, 1.0]], dtype=dtype)
    return GaussianMixture(locs, scales, torch.full((4,), 0.25, dtype=dtype),
                           device)


class WarpedGauss(Distribution):
    """2-D warped (twisted) Gaussian (reference
    `example/targets/warped_gaussian.jl:25-87`): N(0, diag(σ₁², σ₂²))
    pushed through the radius-dependent rotation
    ``ϕ(x) = (r cos(θ − r/2), r sin(θ − r/2))``, r = ‖x‖.

    The rotation is area-preserving, so the normalised density of `sample`
    has no Jacobian term; ``ref_compat=True`` adds the reference's log(r)
    (`warped_gaussian.jl:66-68,85`), which the JAX package keeps as an
    option for parity with the reference."""

    def __init__(self, sigma1: float = 1.0, sigma2: float = 0.12,
                 ref_compat: bool = False):
        super().__init__()
        self.sigma1, self.sigma2 = float(sigma1), float(sigma2)
        self.ref_compat = bool(ref_compat)

    @property
    def event_dim(self) -> int:
        return 2

    def sample(self, generator, sample_shape=(), dtype=torch.float32):
        """Exact draws, made on the generator's device."""
        z = torch.randn(tuple(sample_shape) + (2,), generator=generator,
                        dtype=dtype, device=generator.device)
        zx, zy = z[..., 0] * self.sigma1, z[..., 1] * self.sigma2
        r = (zx.square() + zy.square()).sqrt()
        theta = torch.atan2(zy, zx) - 0.5 * r
        return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)

    def log_prob(self, x):
        # ϕ⁻¹ (warped_gaussian.jl:60-68): θ += r/2
        r = x.square().sum(dim=-1).sqrt()
        theta = torch.atan2(x[..., 1], x[..., 0]) + 0.5 * r
        quad = ((r * torch.cos(theta) / self.sigma1).square()
                + (r * torch.sin(theta) / self.sigma2).square())
        lp = (-0.5 * quad - _LOG_2PI - math.log(self.sigma1)
              - math.log(self.sigma2))
        return lp + torch.log(r) if self.ref_compat else lp

    def score(self, x):
        return _autograd_score(self.log_prob, x)
