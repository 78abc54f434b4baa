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
copy between the last Dense and the kernel. Under the bf16
``compute_dtype`` policy the conditioner's raw reaches the kernel in
bfloat16 (`_feed`), as the JAX Pallas path feeds it; with bfloat16
parameters x and raw are both bfloat16.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from ..ops.masks import PartitionMask, interleave
from ..ops.rqs import DEFAULT_MIN_DERIVATIVE
from ..ops.rqs_cuda import BACKENDS, rqs_fused, rqs_fused_vjp
from ..utils.device import resolve_device
from .bijector import Bijector
from .distributions import DiagNormal, Distribution, TransformedDistribution
from .flows import create_flow
from .linear import ActNorm
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


def _feed(net: MLP, raw: torch.Tensor) -> torch.Tensor:
    """raw as the spline kernel reads it: rounded to bfloat16 when the
    conditioner runs the bf16 policy (JAX `spline.py:124-131`, `:203-215`:
    raw is most of the kernel's traffic), else as it is."""
    cd = net.layers[-1].compute_dtype
    return raw if cd is None else raw.to(cd)


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
             device=None, backend="auto", identity_init=False,
             compute_dtype=None) -> "NeuralSplineCoupling":
        device = resolve_device(device)
        mask = PartitionMask.make(dim, mask_idx)
        n_t = mask.n_transformed
        net = fnn(generator, dim - n_t, hdims, (3 * K - 1) * n_t,
                  dtype=dtype, device=device, compute_dtype=compute_dtype)
        if identity_init:
            _identity_init(net, n_t, K)
        return NeuralSplineCoupling(net, K, B, mask, backend)

    def _transform(self, v, cond, inverse):
        raw = self.nn(cond)
        raw = raw.reshape(raw.shape[:-1] + (v.shape[-1], 3 * self.K - 1))
        return rqs_fused(v, _feed(self.nn, raw), self.B, inverse=inverse,
                         backend=self.backend)

    def forward_and_log_det(self, x):
        x_a, x_b, x_c = self.mask.partition(x)
        y_a, ld = self._transform(x_a, x_b, inverse=False)
        return self.mask.combine(y_a, x_b, x_c), ld.sum(dim=-1)

    def inverse_and_log_det(self, y):
        y_a, y_b, y_c = self.mask.partition(y)
        x_a, ld = self._transform(y_a, y_b, inverse=True)
        return self.mask.combine(x_a, y_b, y_c), ld.sum(dim=-1)


class _PairRemat(torch.autograd.Function):
    """One NSF block under selective remat: ``stack._pair`` with only its
    inputs (u, v) and the first coupling's kernel output u1 saved. The
    backward recomputes the two conditioners from those and runs the RQS
    VJP (K2, or K3 inverse) once a coupling through `rqs_fused_vjp`; the
    kernel forward (K1) is never run again. (The second coupling's output
    is the block's, saved by the next block or the caller.) The JAX
    package's policy is the same: `save_only_these_names("rqs_out")`."""

    @staticmethod
    def forward(ctx, u, v, ld, stack, n1, n2, inverse, *params):
        u1, v1, ld = stack._pair(u, v, ld, n1, n2, inverse)
        ctx.save_for_backward(u, v, u1, *params)
        ctx.stack, ctx.nets, ctx.inverse = stack, (n1, n2), inverse
        ctx.n_first = len(list(n1.parameters()))
        return u1, v1, ld

    @staticmethod
    @once_differentiable
    def backward(ctx, g_u1, g_v1, g_ld):
        u, v, u1, *params = ctx.saved_tensors
        (n1, n2), k = ctx.nets, ctx.n_first
        need = ctx.needs_input_grad[7:]
        vjp = functools.partial(ctx.stack._coupling_vjp, g_ld=g_ld,
                                inverse=ctx.inverse)
        # v1 = RQS(v, n2(u1)), then u1 = RQS(u, n1(v))
        g_v, g_u1_cond, g2 = vjp(v, u1, n2, params[k:], need[k:], g_v1)
        g_u, g_v_cond, g1 = vjp(u, v, n1, params[:k], need[:k],
                                g_u1 + g_u1_cond)
        return (g_u, g_v + g_v_cond, g_ld, None, None, None, None, *g1,
                *g2)


class SplinePairStack(Bijector):
    """N NSF blocks (complementary even/odd `NeuralSplineCoupling` pairs)
    with a split carry: partition once into (x_even, x_odd), run the
    blocks, riffle once. ``stacked["even"][i]`` and ``stacked["odd"][i]``
    are block i's conditioners (the JAX package stacks them along a
    leading axis for `lax.scan`; here a Python loop walks the list).

    ``remat=True`` is JAX's selective remat: a block keeps only its inputs
    and the RQS kernel's output between forward and backward, and its
    backward recomputes the conditioner matmuls but never the kernel
    forward (`_PairRemat`), so K1 runs once a coupling, as without remat.
    `torch.utils.checkpoint` would run K1 again: it cannot see that the
    kernel's outputs are the ones to keep."""

    def __init__(self, even: Sequence[MLP], odd: Sequence[MLP], K: int,
                 B: float, dim: int, backend: str = "auto",
                 remat: bool = False):
        super().__init__()
        _check_backend(backend)
        if len(even) != len(odd):
            raise ValueError("one even and one odd conditioner per block")
        self.stacked = nn.ModuleDict({"even": nn.ModuleList(even),
                                      "odd": nn.ModuleList(odd)})
        self.K, self.B, self.dim, self.backend = int(K), float(B), dim, backend
        self.remat = bool(remat)

    @staticmethod
    def from_pairs(pairs, remat: bool = False) -> "SplinePairStack":
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
                               c0.backend, remat)

    def _transform(self, v, net, cond, inverse):
        n_t = v.shape[-1]
        raw = net(cond)
        raw = raw.reshape(raw.shape[:-1] + (n_t, 3 * self.K - 1))
        y, ld = rqs_fused(v, _feed(net, raw), self.B, inverse=inverse,
                          backend=self.backend)
        return y, ld.sum(dim=-1)

    def _pair(self, u, v, ld, n1, n2, inverse):
        """One block on the carry: u1 = RQS(u; n1(v)), then v1 = RQS(v;
        n2(u1)). Forward, (u, v, n1, n2) is (x_even, x_odd, even, odd);
        inverse, (y_odd, y_even, odd, even). The log-dets add in the order
        of the JAX scan body: the even coupling's first."""
        u1, ld1 = self._transform(u, n1, v, inverse)
        v1, ld2 = self._transform(v, n2, u1, inverse)
        ld = ld + ld2 + ld1 if inverse else ld + ld1 + ld2
        return u1, v1, ld

    def _coupling_vjp(self, x, cond, net, params, need, gy, g_ld, inverse):
        """The VJP of one coupling y = RQS(x; net(cond)) whose log-det sum
        gets ``g_ld``: (gx, gcond, the gradients of ``params`` where
        ``need``). The conditioner is run again on ``cond`` with the saved
        ``params``; the spline's VJP is `rqs_fused_vjp`."""
        names = [n for n, _ in net.named_parameters()]
        with torch.enable_grad():
            cond = cond.detach().requires_grad_()
            leaves = [p.detach().requires_grad_(bool(w))
                      for p, w in zip(params, need)]
            raw = torch.func.functional_call(
                net, dict(zip(names, leaves)), (cond,))
            raw = raw.reshape(raw.shape[:-1] + (x.shape[-1], 3 * self.K - 1))
            gx, graw = rqs_fused_vjp(x, _feed(net, raw.detach()), gy,
                                     g_ld.unsqueeze(-1).expand(x.shape),
                                     self.B, inverse, self.backend)
            wrt = [cond] + [p for p in leaves if p.requires_grad]
            grads = iter(torch.autograd.grad(raw, wrt, graw.to(raw.dtype)))
        gcond = next(grads)
        return gx, gcond, [next(grads) if p.requires_grad else None
                           for p in leaves]

    def _block(self, u, v, ld, n1, n2, inverse):
        if self.remat and torch.is_grad_enabled():
            return _PairRemat.apply(u, v, ld, self, n1, n2, inverse,
                                    *n1.parameters(), *n2.parameters())
        return self._pair(u, v, ld, n1, n2, inverse)

    def forward_and_log_det(self, x):
        xa, xb = x[..., 0::2], x[..., 1::2]
        ld = x.new_zeros(x.shape[:-1])
        for net_e, net_o in zip(self.stacked["even"], self.stacked["odd"]):
            xa, xb, ld = self._block(xa, xb, ld, net_e, net_o, False)
        return interleave(xa, xb, self.dim), ld

    def inverse_and_log_det(self, y):
        ya, yb = y[..., 0::2], y[..., 1::2]
        ld = y.new_zeros(y.shape[:-1])
        for net_e, net_o in zip(reversed(self.stacked["even"]),
                                reversed(self.stacked["odd"])):
            yb, ya, ld = self._block(yb, ya, ld, net_o, net_e, True)
        return interleave(ya, yb, self.dim), ld


def NSF_layer(generator, dim, hdims, K, B, dtype=torch.float32, device=None,
              backend="auto", identity_init=False,
              compute_dtype=None) -> list[NeuralSplineCoupling]:
    """One NSF block: two spline couplings with complementary masks
    (reference `neuralspline.jl:169-184`)."""
    device = resolve_device(device)
    return [NeuralSplineCoupling.make(generator, dim, hdims, K, B,
                                      range(parity, dim, 2), dtype, device,
                                      backend, identity_init, compute_dtype)
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
    identity. ``remat`` is the selective remat of `SplinePairStack`.
    ``affine_wrap`` puts an identity-initialized `ActNorm` on each side
    of the stack, a trainable affine envelope: a bare spline is the
    identity outside [−B, B], so the outer ActNorm maps the box onto the
    target's support and the inner one spreads the base draws over the
    knots. ``compute_dtype=torch.bfloat16`` runs the conditioners under the
    bf16 policy (`nets.Dense`) and feeds the kernels bfloat16 raw;
    ``dtype=torch.bfloat16`` stores every parameter in bfloat16."""
    _check_backend(backend)
    device = resolve_device(device)
    if isinstance(q0, int):
        q0 = DiagNormal.standard(q0, dtype, device)
    dim = q0.event_dim
    pairs = [NSF_layer(generator, dim, hdims, K, B, dtype, device,
                       backend, identity_init, compute_dtype)
             for _ in range(nlayers)]
    layers = [SplinePairStack.from_pairs(pairs, remat=remat)]
    if affine_wrap:
        layers = ([ActNorm.identity(dim, dtype, device)] + layers
                  + [ActNorm.identity(dim, dtype, device)])
    return create_flow(layers, q0)
