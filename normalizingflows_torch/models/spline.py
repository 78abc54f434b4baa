"""Neural spline flow (rational-quadratic coupling).

Counterpart of `normalizingflows/jl_tpu/models/spline.py`:

* `NeuralSplineCoupling`: the conditioner maps x_B to (3K−1)·|A| raw
  spline parameters, and the transformed dims go through the fused RQS
  (`ops/rqs_cuda.py`); log|det J| sums the elementwise log-derivatives.
* `NSF_layer`: two couplings with complementary alternating masks.
* `SplinePairStack`: N such blocks with the split carry of the JAX scan —
  partition once into (even, odd) streams, run the blocks in a Python
  loop, riffle once at the end.
* `nsf`: defaults hdims=(32, 32), K=10, B=30, nlayers=10.

Every constructor builds on ``device``; None is the card, and raises where
there is no CUDA device.

``backend`` is ``"auto"`` (CUDA kernels for CUDA tensors, the plain
version for CPU tensors), ``"plain"`` or ``"cuda"``, mirroring the JAX
``"auto" | "oracle" | "pallas"``. The kernel reads the conditioner's
native (batch·n_t, 3K−1) output through its strides: no transpose and no
copy between the last Dense and the kernel.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.masks import PartitionMask, interleave
from ..ops.rqs import DEFAULT_MIN_DERIVATIVE
from ..ops.rqs_cuda import BACKENDS, rqs_fused
from ..utils.device import resolve_device
from .bijector import Bijector
from .distributions import DiagNormal, Distribution, TransformedDistribution
from .flows import create_flow
from .nets import MLP, fnn

__all__ = ["NeuralSplineCoupling", "NSF_layer", "SplinePairStack", "nsf"]


def _identity_init(net: MLP, n_t: int, K: int):
    """Make a coupling the exact identity: zero the final Dense (softmax(0)
    gives uniform knots, xs == ys) and bias the derivative slots so the
    softplus gives slope exactly 1 at every interior knot."""
    last = net.layers[-1]
    c = math.log(math.expm1(1.0 - DEFAULT_MIN_DERIVATIVE))
    with torch.no_grad():
        last.W.zero_()
        b = last.b.view(n_t, 3 * K - 1)
        b.zero_()
        b[:, 2 * K:] = c


def _check_backend(backend: str):
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


class NeuralSplineCoupling(Bijector):
    """RQS coupling layer (Durkan et al. 2019)."""

    def __init__(self, net: MLP, K: int, B: float, mask: PartitionMask,
                 backend: str = "auto"):
        super().__init__()
        _check_backend(backend)
        self.nn = net
        self.K, self.B = int(K), float(B)
        self.mask, self.backend = mask, backend

    @staticmethod
    def make(generator, dim, hdims, K, B, mask_idx, dtype=torch.float32,
             device=None, backend="auto",
             identity_init=False) -> "NeuralSplineCoupling":
        device = resolve_device(device)
        mask = PartitionMask.make(dim, mask_idx)
        n_t = mask.n_transformed
        net = fnn(generator, dim - n_t, hdims, (3 * K - 1) * n_t,
                  dtype=dtype, device=device)
        if identity_init:
            _identity_init(net, n_t, K)
        return NeuralSplineCoupling(net, K, B, mask, backend)

    def _transform(self, v, cond, inverse):
        raw = self.nn(cond)
        raw = raw.reshape(raw.shape[:-1] + (v.shape[-1], 3 * self.K - 1))
        return rqs_fused(v, raw, self.B, inverse=inverse,
                         backend=self.backend)

    def forward_and_log_det(self, x):
        x_a, x_b, x_c = self.mask.partition(x)
        y_a, ld = self._transform(x_a, x_b, inverse=False)
        return self.mask.combine(y_a, x_b, x_c), ld.sum(dim=-1)

    def inverse_and_log_det(self, y):
        y_a, y_b, y_c = self.mask.partition(y)
        x_a, ld = self._transform(y_a, y_b, inverse=True)
        return self.mask.combine(x_a, y_b, y_c), ld.sum(dim=-1)


class SplinePairStack(Bijector):
    """N NSF blocks (complementary even/odd `NeuralSplineCoupling` pairs)
    with a split carry: partition once into (x_even, x_odd), run the
    blocks, riffle once. ``stacked["even"][i]`` and ``stacked["odd"][i]``
    are block i's conditioners (the JAX package stacks them along a
    leading axis for `lax.scan`; here a Python loop walks the list)."""

    def __init__(self, even: Sequence[MLP], odd: Sequence[MLP], K: int,
                 B: float, dim: int, backend: str = "auto"):
        super().__init__()
        _check_backend(backend)
        if len(even) != len(odd):
            raise ValueError("one even and one odd conditioner per block")
        self.stacked = nn.ModuleDict({"even": nn.ModuleList(even),
                                      "odd": nn.ModuleList(odd)})
        self.K, self.B, self.dim, self.backend = int(K), float(B), dim, backend

    @staticmethod
    def from_pairs(pairs) -> "SplinePairStack":
        c0 = pairs[0][0]
        dim = c0.mask.dim
        even, odd = tuple(range(0, dim, 2)), tuple(range(1, dim, 2))
        for c_e, c_o in pairs:
            if c_e.mask.idx_a != even or c_o.mask.idx_a != odd:
                raise ValueError(
                    "SplinePairStack requires alternating even/odd masks; "
                    "use a Chain of couplings for other masks")
        return SplinePairStack([p[0].nn for p in pairs],
                               [p[1].nn for p in pairs], c0.K, c0.B, dim,
                               c0.backend)

    def _transform(self, v, net, cond, inverse):
        n_t = v.shape[-1]
        raw = net(cond)
        raw = raw.reshape(raw.shape[:-1] + (n_t, 3 * self.K - 1))
        y, ld = rqs_fused(v, raw, self.B, inverse=inverse,
                          backend=self.backend)
        return y, ld.sum(dim=-1)

    def forward_and_log_det(self, x):
        xa, xb = x[..., 0::2], x[..., 1::2]
        ld = x.new_zeros(x.shape[:-1])
        for net_e, net_o in zip(self.stacked["even"], self.stacked["odd"]):
            xa, lde = self._transform(xa, net_e, xb, False)
            xb, ldo = self._transform(xb, net_o, xa, False)
            ld = ld + lde + ldo
        return interleave(xa, xb, self.dim), ld

    def inverse_and_log_det(self, y):
        ya, yb = y[..., 0::2], y[..., 1::2]
        ld = y.new_zeros(y.shape[:-1])
        for net_e, net_o in zip(reversed(self.stacked["even"]),
                                reversed(self.stacked["odd"])):
            yb, ldo = self._transform(yb, net_o, ya, True)
            ya, lde = self._transform(ya, net_e, yb, True)
            ld = ld + lde + ldo
        return interleave(ya, yb, self.dim), ld


def NSF_layer(generator, dim, hdims, K, B, dtype=torch.float32, device=None,
              backend="auto",
              identity_init=False) -> list[NeuralSplineCoupling]:
    """One NSF block: two spline couplings with complementary masks
    (reference `neuralspline.jl:169-184`)."""
    device = resolve_device(device)
    return [NeuralSplineCoupling.make(generator, dim, hdims, K, B,
                                      range(parity, dim, 2), dtype, device,
                                      backend, identity_init)
            for parity in (0, 1)]


def nsf(
    generator: torch.Generator,
    q0: Distribution | int,
    hdims: Sequence[int] = (32, 32),
    K: int = 10,
    B: float = 30.0,
    nlayers: int = 10,
    dtype=torch.float32,
    device=None,
    backend: str = "auto",
    identity_init: bool = False,
    remat: bool = False,
    compute_dtype=None,
    affine_wrap: bool = False,
) -> TransformedDistribution:
    """Neural spline flow (reference `neuralspline.jl:218-234` defaults):
    one `SplinePairStack` of ``nlayers`` blocks, the JAX ``scan=True``
    layout. ``identity_init`` makes every coupling start as the exact
    identity. ``remat``, ``compute_dtype`` and ``affine_wrap`` are not
    ported yet and raise unless left at their defaults."""
    if remat or compute_dtype is not None or affine_wrap:
        raise NotImplementedError(
            "nsf(remat=, compute_dtype=, affine_wrap=) are not ported yet")
    _check_backend(backend)
    device = resolve_device(device)
    if isinstance(q0, int):
        q0 = DiagNormal.standard(q0, dtype, device)
    pairs = [NSF_layer(generator, q0.event_dim, hdims, K, B, dtype, device,
                       backend, identity_init) for _ in range(nlayers)]
    return create_flow([SplinePairStack.from_pairs(pairs)], q0)
