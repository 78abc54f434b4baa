"""MLP conditioner networks.

Counterpart of `normalizingflows/jl_tpu/models/nets.py`: `Dense`, `MLP`
and `fnn` with Flux's defaults (Glorot-uniform weights, zero bias,
leaky-relu slope 0.01). Weights are stored ``(in_dim, out_dim)`` as in the
JAX package, so parameters cross between the two without a transpose, and
applied as ``x @ W + b`` on ``(..., in_dim)`` batches. float32 and float64
only: the bf16 ``compute_dtype`` policy is not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

__all__ = ["Dense", "MLP", "fnn", "mlp3", "leaky_relu"]


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """Flux's `leakyrelu` default (slope 0.01)."""
    return F.leaky_relu(x, negative_slope=0.01)


def _check_dtype(dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"float32 or float64 parameters only, got {dtype}")


class Dense(nn.Module):
    """One affine layer with activation: act(x @ W + b)."""

    def __init__(self, W: torch.Tensor, b: torch.Tensor,
                 activation: Callable | None = None):
        super().__init__()
        _check_dtype(W.dtype)
        self.W = nn.Parameter(W)
        self.b = nn.Parameter(b)
        self.activation = activation

    @staticmethod
    def make(generator: torch.Generator, in_dim: int, out_dim: int,
             activation=None, dtype=torch.float32, device=None) -> "Dense":
        """Glorot-uniform W and zero b on ``device`` (None: the card). The
        draws are made on the generator's device and then moved, so one seed
        gives the same weights on every device."""
        _check_dtype(dtype)
        device = resolve_device(device)
        limit = math.sqrt(6.0 / (in_dim + out_dim))
        W = torch.empty((in_dim, out_dim), dtype=dtype,
                        device=generator.device)
        W.uniform_(-limit, limit, generator=generator)
        b = torch.zeros((out_dim,), dtype=dtype, device=device)
        return Dense(W.to(device), b, activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.W.T, self.b)
        return y if self.activation is None else self.activation(y)


class MLP(nn.Module):
    """Chain of Dense layers (Flux.Chain equivalent)."""

    def __init__(self, layers: Sequence[Dense]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x

    @property
    def in_dim(self) -> int:
        return self.layers[0].W.shape[0]

    @property
    def out_dim(self) -> int:
        return self.layers[-1].W.shape[1]


def fnn(
    generator: torch.Generator,
    input_dim: int,
    hidden_dims: Sequence[int],
    output_dim: int,
    inlayer_activation: Callable = leaky_relu,
    output_activation: Callable | None = None,
    dtype=torch.float32,
    device=None,
) -> MLP:
    """Fully-connected network (reference `fnn`, `src/flows/utils.jl:71-100`):
    hidden layers with ``inlayer_activation``, optional output activation,
    on ``device`` (None: the card)."""
    device = resolve_device(device)
    dims = [input_dim, *hidden_dims, output_dim]
    layers = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        act = output_activation if i == len(dims) - 2 else inlayer_activation
        layers.append(Dense.make(generator, din, dout, act, dtype, device))
    return MLP(layers)


def mlp3(
    generator: torch.Generator,
    input_dim: int,
    hidden_dim: int,
    output_dim: int,
    activation: Callable = leaky_relu,
    dtype=torch.float32,
    device=None,
) -> MLP:
    """3-layer MLP (reference `mlp3`, `src/flows/utils.jl:33-46`): in→h
    (act), h→h (act), h→out (linear), on ``device`` (None: the card)."""
    return fnn(generator, input_dim, [hidden_dim, hidden_dim], output_dim,
               inlayer_activation=activation, dtype=dtype, device=device)
