"""Base distributions and the transformed-distribution wrapper.

Counterpart of `normalizingflows/jl_tpu/models/distributions.py`. Where
JAX takes a PRNG ``key`` these take a ``torch.Generator``, which must live
on the device the samples are drawn on. ``device=None`` is the card.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.device import resolve_device
from .bijector import Bijector

__all__ = [
    "Distribution", "DiagNormal", "StandardNormal", "TransformedDistribution",
    "transformed",
]

_LOG_2PI = math.log(2.0 * math.pi)


class Distribution(nn.Module):
    """Minimal distribution protocol: `sample`, `log_prob`, `event_dim`."""

    def sample(self, generator: torch.Generator,
               sample_shape: tuple = ()) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def event_dim(self) -> int:
        raise NotImplementedError


class DiagNormal(Distribution):
    """Normal with diagonal covariance; ``scale`` is the standard deviation
    per dimension. The flow's base; training freezes it by default."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.loc = nn.Parameter(loc)
        self.scale = nn.Parameter(scale)

    @staticmethod
    def standard(dim: int, dtype=torch.float32, device=None) -> "DiagNormal":
        device = resolve_device(device)
        return DiagNormal(torch.zeros((dim,), dtype=dtype, device=device),
                          torch.ones((dim,), dtype=dtype, device=device))

    @property
    def event_dim(self) -> int:
        return self.loc.shape[-1]

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype,
                          device=self.loc.device)
        return self.loc + self.scale * eps

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return (-0.5 * z.square().sum(dim=-1) - torch.log(self.scale).sum()
                - 0.5 * self.event_dim * _LOG_2PI)


class StandardNormal(Distribution):
    """N(0, I) with a fixed dimension and no parameters."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dim, self.dtype = int(dim), dtype
        self.device = resolve_device(device)

    @property
    def event_dim(self) -> int:
        return self.dim

    def sample(self, generator, sample_shape=()):
        return torch.randn(tuple(sample_shape) + (self.dim,),
                           generator=generator, dtype=self.dtype,
                           device=self.device)

    def log_prob(self, x):
        return -0.5 * x.square().sum(dim=-1) - 0.5 * self.dim * _LOG_2PI


class TransformedDistribution(Distribution):
    """Pushforward of ``base`` through ``bijector``: the flow.

    * ``sample``: x ~ base; y = T(x)
    * ``log_prob``: x, ld = T⁻¹(y); base.log_prob(x) + ld
    * ``sample_and_log_prob``: (y, log q(y)) in one forward traversal, via
      log q(y) = base.log_prob(x) − log|det J_T(x)| (the ELBO's path).
    """

    def __init__(self, base: Distribution, bijector: Bijector):
        super().__init__()
        self.base = base
        self.bijector = bijector

    @property
    def event_dim(self) -> int:
        return self.base.event_dim

    def sample(self, generator, sample_shape=()):
        return self.bijector.forward(self.base.sample(generator, sample_shape))

    def sample_and_log_prob(self, generator, sample_shape=()):
        x = self.base.sample(generator, sample_shape)
        y, log_det = self.bijector.forward_and_log_det(x)
        return y, self.base.log_prob(x) - log_det

    def sample_with_base(self, generator, sample_shape=()):
        """(x, y, log|det J_T(x)|): the ingredients of the ELBO estimator."""
        x = self.base.sample(generator, sample_shape)
        y, log_det = self.bijector.forward_and_log_det(x)
        return x, y, log_det

    def log_prob(self, y):
        x, log_det = self.bijector.inverse_and_log_det(y)
        return self.base.log_prob(x) + log_det


def transformed(base: Distribution,
                bijector: Bijector) -> TransformedDistribution:
    """Bijectors.jl `transformed(q0, T)`."""
    return TransformedDistribution(base, bijector)
