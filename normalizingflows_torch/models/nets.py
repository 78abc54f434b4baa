"""MLP conditioner networks.

Counterpart of `normalizingflows/jl_tpu/models/nets.py`: `Dense`, `MLP`
and `fnn` with Flux's defaults (Glorot-uniform weights, zero bias,
leaky-relu slope 0.01). Weights are stored ``(in_dim, out_dim)`` as in the
JAX package, so parameters cross between the two without a transpose, and
applied as ``x @ W + b`` on ``(..., in_dim)`` batches.

Parameters are float32, float64 or bfloat16 (the reference's
``paramtype``; a bfloat16 `Dense` is a plain bfloat16 matmul).
``compute_dtype=torch.bfloat16`` is the mixed-precision policy of JAX's
`Dense`: the parameters stay in their stored dtype, the product's
operands go to bfloat16 and it accumulates in float32 (`_MixedMatmul`),
and the bias add and activation run in the parameters' dtype. These
products are cuBLAS calls, not kernels of the package: the JAX package
leaves them to XLA too.
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
    if dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise TypeError(f"float32, float64 or bfloat16 parameters only, got "
                        f"{dtype}")


def _check_compute_dtype(cd):
    if cd not in (None, torch.bfloat16):
        raise TypeError(f"compute_dtype is None or torch.bfloat16, got {cd}")


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) @ b (k, n), both bfloat16, summed in float32 and returned
    unrounded in float32: JAX's TPU semantics (``preferred_element_type=
    float32``). On the card it is one cuBLAS call, ``aten::mm.dtype``,
    whose bits do not depend on
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    (left as it is). On the CPU, which has no such call, it is the float32
    product of the operands widened (exactly: a product of two bfloat16
    values is exact in float32). That is also what the JAX package runs on
    the CPU: its source rounds the product to bfloat16 there
    (`jl_tpu/models/nets.py:101-106`), but under `jax.jit`, which every
    training step and scan is, XLA folds that rounding into the dot."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _MixedMatmul(torch.autograd.Function):
    """x (..., k) @ W (k, n) under the bf16 policy (JAX `_mixed_matmul`):
    both operands rounded to ``cd``, float32 accumulation, the product in
    W's dtype. The backward keeps both of its products in ``cd`` too:
    gx = g·Wᵀ and gW = xᵀ·g from the cotangent rounded to ``cd``, each
    accumulated in float32 and cast to x's and W's dtypes. It saves the
    rounded operands, which are all the backward reads."""

    @staticmethod
    def forward(ctx, x, W, cd):
        xc = x.reshape(-1, x.shape[-1]).to(cd)
        Wc = W.to(cd)
        ctx.save_for_backward(xc, Wc)
        ctx.cd, ctx.x_shape = cd, x.shape
        ctx.dtypes = x.dtype, W.dtype
        y = _product(xc, Wc).to(W.dtype)
        return y.reshape(x.shape[:-1] + (W.shape[1],))

    @staticmethod
    def backward(ctx, g):
        xc, Wc = ctx.saved_tensors
        gc = g.reshape(-1, g.shape[-1]).to(ctx.cd)
        gx = gW = None
        if ctx.needs_input_grad[0]:
            gx = _product(gc, Wc.T).to(ctx.dtypes[0]).reshape(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            gW = _product(xc.T, gc).to(ctx.dtypes[1])
        return gx, gW, None


class Dense(nn.Module):
    """One affine layer with activation: act(x @ W + b). With
    ``compute_dtype=torch.bfloat16`` the product runs under the bf16
    policy (`_MixedMatmul`); the bias add and the activation stay in W's
    dtype."""

    def __init__(self, W: torch.Tensor, b: torch.Tensor,
                 activation: Callable | None = None, compute_dtype=None):
        super().__init__()
        _check_dtype(W.dtype)
        _check_compute_dtype(compute_dtype)
        self.W = nn.Parameter(W)
        self.b = nn.Parameter(b)
        self.activation = activation
        self.compute_dtype = compute_dtype

    @staticmethod
    def make(generator: torch.Generator, in_dim: int, out_dim: int,
             activation=None, dtype=torch.float32, device=None,
             compute_dtype=None) -> "Dense":
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
        return Dense(W.to(device), b, activation, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            y = _MixedMatmul.apply(x, self.W, self.compute_dtype) + self.b
        else:
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
    compute_dtype=None,
) -> MLP:
    """Fully-connected network (reference `fnn`, `src/flows/utils.jl:71-100`):
    hidden layers with ``inlayer_activation``, optional output activation,
    on ``device`` (None: the card); ``compute_dtype`` sets every layer's
    bf16 policy (see `Dense`)."""
    device = resolve_device(device)
    dims = [input_dim, *hidden_dims, output_dim]
    layers = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        act = output_activation if i == len(dims) - 2 else inlayer_activation
        layers.append(Dense.make(generator, din, dout, act, dtype, device,
                                 compute_dtype))
    return MLP(layers)


def mlp3(
    generator: torch.Generator,
    input_dim: int,
    hidden_dim: int,
    output_dim: int,
    activation: Callable = leaky_relu,
    dtype=torch.float32,
    device=None,
    compute_dtype=None,
) -> MLP:
    """3-layer MLP (reference `mlp3`, `src/flows/utils.jl:33-46`): in→h
    (act), h→h (act), h→out (linear), on ``device`` (None: the card), under
    ``compute_dtype``'s policy (see `Dense`)."""
    return fnn(generator, input_dim, [hidden_dim, hidden_dim], output_dim,
               inlayer_activation=activation, dtype=dtype, device=device,
               compute_dtype=compute_dtype)
