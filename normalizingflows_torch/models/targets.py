"""Synthetic target distributions (counterpart of `jl_tpu/models/targets.py`).

Only `Banana` so far; the other targets follow in later slices.
"""

from __future__ import annotations

import math

import torch

from .distributions import Distribution

__all__ = ["Banana"]

_LOG_2PI = math.log(2.0 * math.pi)


class Banana(Distribution):
    """Banana distribution of Roberts & Rosenthal (2009).

    N(0, diag(var, 1, …, 1)) pushed through the unit-Jacobian map
    ``ϕ(x) = (x₁, x₂ − b·x₁² + var·b, x₃, …)`` (reference
    `example/targets/banana.jl:53-83`). Banana(2, 1, 100) is the "hard"
    demo target."""

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
