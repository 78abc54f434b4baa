"""Masked autoregressive flows (MAF / IAF).

Counterpart of `normalizingflows/jl_tpu/models/autoregressive.py` (MADE:
Germain et al. 2015; MAF: Papamakarios et al. 2017; IAF: Kingma et al.
2016). An affine autoregressive transform ``y_i = x_i·exp(s_i(x_{<i})) +
t_i(x_{<i})`` is triangular, so its log-det is ``Σ s_i``, and one masked
MLP pass (MADE) gives every conditioner output at once. The sequential
direction runs the masked pass ``dim`` times (exact: iteration k settles
dimension k), a Python loop with the JAX `fori_loop`'s static trip count.

* `iaf`: the parallel direction is the forward one — sampling and the
  reverse-KL ELBO;
* `maf`: each layer wrapped in `Inverse` — `log_prob` and maximum
  likelihood are parallel, sampling sequential.

Both interleave `Permute` (order reversal) between layers. The masks and
the permutation's indices are buffers made once at construction, on the
module's device, so a step makes no host→device copy and a CUDA graph can
capture it. They are not persistent: the JAX package keeps the degrees and
the permutation as static fields, not leaves.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .bijector import Bijector, Inverse, _zero_log_det
from .distributions import DiagNormal, Distribution, TransformedDistribution
from .flows import create_flow
from .nets import _check_dtype, leaky_relu

__all__ = ["MADE", "MaskedAutoregressive", "MaskedDense", "Permute", "iaf",
           "maf", "maf_layer"]


class MaskedDense(nn.Module):
    """Dense layer ``act(x @ (W ⊙ mask) + b)`` with a static
    autoregressive mask: connection i→j is kept iff ``out_degree_j ≥
    in_degree_i`` (``out_degree_j > in_degree_i`` where ``strict``, the
    output layer, so output j never sees input j)."""

    def __init__(self, W: torch.Tensor, b: torch.Tensor,
                 in_degrees: Sequence[int], out_degrees: Sequence[int],
                 strict: bool = False, activation: Callable | None = None):
        super().__init__()
        _check_dtype(W.dtype)
        self.W = nn.Parameter(W)
        self.b = nn.Parameter(b)
        self.in_degrees = tuple(int(d) for d in in_degrees)
        self.out_degrees = tuple(int(d) for d in out_degrees)
        self.strict, self.activation = bool(strict), activation
        din = torch.tensor(self.in_degrees)[:, None]
        dout = torch.tensor(self.out_degrees)[None, :]
        mask = (dout > din) if self.strict else (dout >= din)
        self.register_buffer("mask", mask.to(device=W.device, dtype=W.dtype),
                             persistent=False)

    @staticmethod
    def make(generator: torch.Generator, in_degrees, out_degrees,
             strict=False, activation=None, dtype=torch.float32,
             device=None) -> "MaskedDense":
        """Glorot-uniform W (drawn on the generator's device, then moved)
        and zero b, as `nets.Dense.make`."""
        _check_dtype(dtype)
        device = resolve_device(device)
        in_dim, out_dim = len(in_degrees), len(out_degrees)
        limit = math.sqrt(6.0 / (in_dim + out_dim))
        W = torch.empty((in_dim, out_dim), dtype=dtype,
                        device=generator.device)
        W.uniform_(-limit, limit, generator=generator)
        b = torch.zeros((out_dim,), dtype=dtype, device=device)
        return MaskedDense(W.to(device), b, in_degrees, out_degrees, strict,
                           activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, (self.W * self.mask).T, self.b)
        return y if self.activation is None else self.activation(y)


class MADE(nn.Module):
    """Masked MLP giving ``(shift, tanh(raw log-scale))`` for every
    dimension in one pass, each depending only on strictly earlier
    inputs. Hidden degrees are ``(i mod max(dim−1, 1)) + 1``; the output
    layer is strict, the shift head before the log-scale head."""

    def __init__(self, layers: Sequence[MaskedDense], dim: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.dim = int(dim)

    @staticmethod
    def make(generator, dim, hidden_dims: Sequence[int],
             activation=leaky_relu, dtype=torch.float32,
             device=None) -> "MADE":
        device = resolve_device(device)
        in_deg = tuple(range(1, dim + 1))
        hidden_degs = [tuple((i % max(dim - 1, 1)) + 1 for i in range(h))
                       for h in hidden_dims]
        out_deg = in_deg + in_deg  # (shift ‖ log-scale) heads
        degs = [in_deg, *hidden_degs]
        layers = []
        for i in range(len(degs)):
            last = i == len(degs) - 1
            layers.append(MaskedDense.make(
                generator, degs[i], out_deg if last else degs[i + 1],
                strict=last, activation=None if last else activation,
                dtype=dtype, device=device))
        return MADE(layers, dim)

    def forward(self, x: torch.Tensor):
        h = x
        for layer in self.layers:
            h = layer(h)
        return h[..., :self.dim], torch.tanh(h[..., self.dim:])


class Permute(Bijector):
    """Static index permutation (log-det 0), interleaved between
    autoregressive layers so the conditioning order alternates. The index
    and its inverse are computed in Python and kept as buffers."""

    def __init__(self, perm: Sequence[int], device=None):
        super().__init__()
        device = resolve_device(device)
        self.perm = tuple(int(i) for i in perm)
        inv = sorted(range(len(self.perm)), key=self.perm.__getitem__)
        self.register_buffer("index", torch.tensor(self.perm, device=device),
                             persistent=False)
        self.register_buffer("inverse_index", torch.tensor(inv, device=device),
                             persistent=False)

    @staticmethod
    def reverse(dim: int, device=None) -> "Permute":
        return Permute(tuple(range(dim - 1, -1, -1)), device)

    def forward_and_log_det(self, x):
        return x.index_select(-1, self.index), _zero_log_det(x)

    def inverse_and_log_det(self, y):
        return y.index_select(-1, self.inverse_index), _zero_log_det(y)


class MaskedAutoregressive(Bijector):
    """Affine autoregressive bijector, parallel in the forward direction:
    ``y = x·exp(s(x)) + t(x)`` in one MADE pass, log-det ``Σ s``. The
    inverse is ``dim`` fixed-point iterations of ``x ← (y − t(x))·exp(−s(x))``
    from x = 0, exact because the dependency is strictly triangular."""

    def __init__(self, made: MADE):
        super().__init__()
        self.made = made

    def forward_and_log_det(self, x):
        t, s = self.made(x)
        return x * torch.exp(s) + t, s.sum(dim=-1)

    def inverse_and_log_det(self, y):
        x = torch.zeros_like(y)
        for _ in range(self.made.dim):
            t, s = self.made(x)
            x = (y - t) * torch.exp(-s)
        _, s = self.made(x)
        return x, -s.sum(dim=-1)


def maf_layer(generator: torch.Generator, dim: int,
              hidden_dims: Sequence[int] = (32, 32), dtype=torch.float32,
              device=None) -> MaskedAutoregressive:
    """One affine masked-autoregressive bijector (parallel forward)."""
    return MaskedAutoregressive(MADE.make(generator, dim, hidden_dims,
                                          dtype=dtype, device=device))


def _ar_stack(generator, q0, hidden_dims, nlayers, dtype, device, wrap):
    device = resolve_device(device)
    if isinstance(q0, int):
        q0 = DiagNormal.standard(q0, dtype, device)
    dim = q0.event_dim
    layers = []
    for i in range(nlayers):
        if i:
            layers.append(Permute.reverse(dim, device))
        layers.append(wrap(maf_layer(generator, dim, hidden_dims, dtype,
                                     device)))
    return create_flow(layers, q0)


def iaf(generator: torch.Generator, q0: Distribution | int,
        hidden_dims: Sequence[int] = (32, 32), nlayers: int = 5,
        dtype=torch.float32, device=None) -> TransformedDistribution:
    """Inverse-autoregressive flow (Kingma et al. 2016): sampling and the
    reverse-KL ELBO take one pass a layer; ``log_prob`` takes ``dim``."""
    return _ar_stack(generator, q0, hidden_dims, nlayers, dtype, device,
                     lambda b: b)


def maf(generator: torch.Generator, q0: Distribution | int,
        hidden_dims: Sequence[int] = (32, 32), nlayers: int = 5,
        dtype=torch.float32, device=None) -> TransformedDistribution:
    """Masked autoregressive flow (Papamakarios et al. 2017): ``log_prob``
    (maximum likelihood, `train_flow_mle`) takes one pass a layer;
    sampling takes ``dim``."""
    return _ar_stack(generator, q0, hidden_dims, nlayers, dtype, device,
                     Inverse)
