"""Banana target of Roberts & Rosenthal (2009), as NormalizingFlows.jl
`example/targets/banana.jl` defines it: N(0, diag(var, 1, ..., 1)) pushed
through phi(x) = (x1, x2 - b * x1^2 + var * b, x3, ...), whose Jacobian
has determinant 1."""

from __future__ import annotations

import math

import torch


def log_prob(y: torch.Tensor, dim: int, b: float, var: float) -> torch.Tensor:
    z2 = y[..., 1] + b * y[..., 0] ** 2 - var * b
    quad = y[..., 0] ** 2 / var + z2 ** 2 + (y[..., 2:] ** 2).sum(dim=-1)
    return -0.5 * (dim * math.log(2 * math.pi) + math.log(var)) - 0.5 * quad
