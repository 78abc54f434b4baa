"""Bijector protocol, combinators and the elementwise affine maps.

Counterpart of `normalizingflows/jl_tpu/models/bijector.py`. Tensors are
row-major batches ``(..., dim)``; ``forward_and_log_det`` /
``inverse_and_log_det`` return ``(out, log_det)`` with ``log_det`` shaped
like the batch ``(...,)``. ``Chain([f, g])`` applies ``f`` first.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

__all__ = ["Bijector", "Identity", "Inverse", "Chain", "invert", "Shift",
           "Scale"]


def _zero_log_det(x: torch.Tensor) -> torch.Tensor:
    return x.new_zeros(x.shape[:-1])


class Bijector(nn.Module):
    """Invertible transform with tractable log|det J|. ``forward(x)`` (and
    so calling the module) returns the transformed tensor alone."""

    def forward_and_log_det(self, x: torch.Tensor):
        raise NotImplementedError

    def inverse_and_log_det(self, y: torch.Tensor):
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_and_log_det(x)[0]

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return self.inverse_and_log_det(y)[0]


class Identity(Bijector):
    """y = x, log|det J| = 0."""

    def forward_and_log_det(self, x):
        return x, _zero_log_det(x)

    def inverse_and_log_det(self, y):
        return y, _zero_log_det(y)


class Inverse(Bijector):
    """The inverse of another bijector."""

    def __init__(self, bijector: Bijector):
        super().__init__()
        self.bijector = bijector

    def forward_and_log_det(self, x):
        return self.bijector.inverse_and_log_det(x)

    def inverse_and_log_det(self, y):
        return self.bijector.forward_and_log_det(y)


def invert(b: Bijector) -> Bijector:
    """Invert a bijector, collapsing double inversion."""
    if isinstance(b, Inverse):
        return b.bijector
    return Inverse(b)


class Chain(Bijector):
    """Composition; ``bijectors[0]`` is applied FIRST in the forward pass."""

    def __init__(self, bijectors: Sequence[Bijector]):
        super().__init__()
        self.bijectors = nn.ModuleList(bijectors)

    def forward_and_log_det(self, x):
        log_det = _zero_log_det(x)
        for b in self.bijectors:
            x, ld = b.forward_and_log_det(x)
            log_det = log_det + ld
        return x, log_det

    def inverse_and_log_det(self, y):
        log_det = _zero_log_det(y)
        for b in reversed(self.bijectors):
            y, ld = b.inverse_and_log_det(y)
            log_det = log_det + ld
        return y, log_det


class Shift(Bijector):
    """y = x + b (Bijectors.jl `Shift`; the mean-field flow's location)."""

    def __init__(self, b: torch.Tensor):
        super().__init__()
        self.b = nn.Parameter(b)

    def forward_and_log_det(self, x):
        return x + self.b, _zero_log_det(x)

    def inverse_and_log_det(self, y):
        return y - self.b, _zero_log_det(y)


class Scale(Bijector):
    """y = a ⊙ x with log|det J| = Σ log|a| (Bijectors.jl `Scale`). No
    positivity constraint on ``a``: the log-det takes log|a|, so a sign
    flip stays a valid bijection, as in the reference."""

    def __init__(self, a: torch.Tensor):
        super().__init__()
        self.a = nn.Parameter(a)

    def _log_det(self, x):
        ld = torch.log(torch.abs(self.a)).sum()
        return ld.expand(x.shape[:-1]).to(x.dtype)

    def forward_and_log_det(self, x):
        return x * self.a, self._log_det(x)

    def inverse_and_log_det(self, y):
        return y / self.a, -self._log_det(y)
