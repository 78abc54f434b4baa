"""Invertible linear-algebra bijectors: ActNorm and PLU-parameterized dense
mixing (the Glow components for flat vectors).

Counterpart of `normalizingflows/jl_tpu/models/linear.py` (Kingma &
Dhariwal, "Glow", NeurIPS 2018):

* `ActNorm`: a per-dimension affine with Glow's data-dependent init.
* `InvertibleLinear`: y = x Wᵀ with W = P·L·(U + diag(s)); P and sign(s)
  are frozen at init, so log|det J| = Σ log|s| and the inverse is two
  triangular solves. ``lower``, ``upper`` and ``log_s`` are parameters;
  ``pmat`` and ``sign_s`` are buffers, which no optimizer sees (the JAX
  package masks them with ``__trainable__``). The three matmuls run in
  exact float32: the package turns TF32 off, as JAX asks for
  ``Precision.HIGHEST``.
* `GlowBlock`: ActNorm → InvertibleLinear → a RealNVP coupling pair.
* `glow`: ``nlayers`` blocks as one `Repeated` (JAX's ``scan=True``
  layout; a `Chain` of the blocks builds its ``scan=False`` one).
* `glow_init_actnorms`: Glow's data-dependent init of every top-level
  ActNorm, in place.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from .bijector import Bijector, Repeated, stack_bijectors
from .distributions import DiagNormal, TransformedDistribution

__all__ = ["ActNorm", "GlowBlock", "InvertibleLinear", "glow",
           "glow_init_actnorms"]


def _broadcast_log_det(ld: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return ld.expand(x.shape[:-1]).to(x.dtype)


class ActNorm(Bijector):
    """Per-dimension affine ``y = x·exp(log_scale) + shift`` with
    data-dependent init; log|det J| = Σ log_scale."""

    def __init__(self, log_scale: torch.Tensor, shift: torch.Tensor):
        super().__init__()
        self.log_scale = nn.Parameter(log_scale)
        self.shift = nn.Parameter(shift)

    @staticmethod
    def identity(dim: int, dtype=torch.float32, device=None) -> "ActNorm":
        device = resolve_device(device)
        return ActNorm(torch.zeros((dim,), dtype=dtype, device=device),
                       torch.zeros((dim,), dtype=dtype, device=device))

    @staticmethod
    def initialize(x: torch.Tensor, eps: float = 1e-6,
                   dtype=None) -> "ActNorm":
        """Glow's init from a (batch, dim) batch: the layer maps that batch
        to zero mean and unit variance per dimension. The standard
        deviation is the population one (ddof 0, as `jnp.std`). ``dtype``
        pins the parameters' dtype (default x's), on x's device."""
        x = x.detach()
        mu = x.mean(dim=0)
        sigma = x.std(dim=0, correction=0) + eps
        log_scale = -torch.log(sigma)
        shift = -mu * torch.exp(log_scale)
        if dtype is not None:
            log_scale, shift = log_scale.to(dtype), shift.to(dtype)
        return ActNorm(log_scale, shift)

    def forward_and_log_det(self, x):
        y = x * torch.exp(self.log_scale) + self.shift
        return y, _broadcast_log_det(self.log_scale.sum(), x)

    def inverse_and_log_det(self, y):
        x = (y - self.shift) * torch.exp(-self.log_scale)
        return x, _broadcast_log_det(-self.log_scale.sum(), y)


class InvertibleLinear(Bijector):
    """Dense invertible mixing ``y = x @ Wᵀ``, W = P·L·(U + diag(s)), P and
    sign(s) frozen (buffers), log|det J| = Σ log|s|."""

    def __init__(self, lower, upper, log_s, pmat, sign_s):
        super().__init__()
        self.lower = nn.Parameter(lower)
        self.upper = nn.Parameter(upper)
        self.log_s = nn.Parameter(log_s)
        self.register_buffer("pmat", pmat)
        self.register_buffer("sign_s", sign_s)

    @staticmethod
    def make(seed: "int | torch.Generator", dim: int, dtype=torch.float32,
             device=None) -> "InvertibleLinear":
        """W a random rotation (log-det 0), PLU-decomposed on the host. An
        int ``seed`` draws the rotation with numpy exactly as the JAX
        package does for an int, so both give the same factors; a
        `torch.Generator` draws it in float32 on the generator's device."""
        import scipy.linalg

        device = resolve_device(device)
        if isinstance(seed, (int, np.integer)):
            a = np.random.default_rng(int(seed)).normal(size=(dim, dim))
        else:
            a = torch.randn((dim, dim), generator=seed, dtype=torch.float32,
                            device=seed.device).cpu().numpy()
        q, _ = np.linalg.qr(np.asarray(a, np.float64))
        p, l, u = scipy.linalg.lu(q)
        s = np.diag(u)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return InvertibleLinear(t(np.tril(l, -1)), t(np.triu(u, 1)),
                                t(np.log(np.abs(s))), t(p), t(np.sign(s)))

    def _plu(self):
        d = self.log_s.shape[0]
        eye = torch.eye(d, dtype=self.log_s.dtype, device=self.log_s.device)
        L = torch.tril(self.lower, -1) + eye
        U = torch.triu(self.upper, 1) + torch.diag(
            self.sign_s * torch.exp(self.log_s))
        return L, U

    def forward_and_log_det(self, x):
        L, U = self._plu()
        y = torch.matmul(x, U.T)
        y = torch.matmul(y, L.T)
        y = torch.matmul(y, self.pmat.T)
        return y, _broadcast_log_det(self.log_s.sum(), x)

    def inverse_and_log_det(self, y):
        L, U = self._plu()
        z = torch.matmul(y, self.pmat)  # row convention: Pᵀ y
        d = z.shape[-1]
        cols = z.reshape(-1, d).T  # the whole batch in one (d, n) solve
        cols = torch.linalg.solve_triangular(L, cols, upper=False)
        cols = torch.linalg.solve_triangular(U, cols, upper=True)
        x = cols.T.reshape(z.shape)
        return x, _broadcast_log_det(-self.log_s.sum(), y)


class GlowBlock(Bijector):
    """One glow block: ActNorm → InvertibleLinear → coupling pair. The
    blocks are structurally identical, so a deep glow is one `Repeated`."""

    def __init__(self, actnorm: ActNorm, mix: InvertibleLinear,
                 c_even: Bijector, c_odd: Bijector):
        super().__init__()
        self.actnorm, self.mix = actnorm, mix
        self.c_even, self.c_odd = c_even, c_odd

    def _parts(self):
        return (self.actnorm, self.mix, self.c_even, self.c_odd)

    def forward_and_log_det(self, x):
        ld = x.new_zeros(x.shape[:-1])
        for b in self._parts():
            x, ldi = b.forward_and_log_det(x)
            ld = ld + ldi
        return x, ld

    def inverse_and_log_det(self, y):
        ld = y.new_zeros(y.shape[:-1])
        for b in reversed(self._parts()):
            y, ldi = b.inverse_and_log_det(y)
            ld = ld + ldi
        return y, ld


def glow(
    generator: torch.Generator,
    q0,
    hdims: Sequence[int] = (32, 32),
    nlayers: int = 3,
    dtype=torch.float32,
    device=None,
    compute_dtype=None,
    remat: bool = False,
    mix_seed: int = 0,
) -> TransformedDistribution:
    """Glow-style flow for flat vectors: ``nlayers`` blocks of ActNorm →
    InvertibleLinear → RealNVP coupling pair (the unfused
    `coupling.RealNVP_layer`), as one `Repeated` (``remat``: see
    `Repeated`). The ActNorms start as the identity: call
    `glow_init_actnorms` with a base batch for Glow's init. Block i's
    rotation is drawn from the int seed ``mix_seed·1000003 + i``, as in
    the JAX package. ``q0`` may be a base distribution or an int dim.
    ``compute_dtype`` (the bf16 policy) is not ported yet and raises."""
    from .coupling import RealNVP_layer
    from .flows import create_flow

    if compute_dtype is not None:
        raise NotImplementedError("glow(compute_dtype=) is not ported yet")
    device = resolve_device(device)
    if isinstance(q0, int):
        q0 = DiagNormal.standard(q0, dtype, device)
    dim = q0.event_dim
    blocks = []
    for i in range(nlayers):
        c_even, c_odd = RealNVP_layer(generator, dim, hdims, dtype, device)
        blocks.append(GlowBlock(
            ActNorm.identity(dim, dtype, device),
            InvertibleLinear.make(mix_seed * 1000003 + i, dim, dtype, device),
            c_even, c_odd))
    return create_flow([stack_bijectors(blocks, remat=remat)], q0)


@torch.no_grad()
def glow_init_actnorms(flow: TransformedDistribution,
                       x: torch.Tensor) -> TransformedDistribution:
    """Glow's data-dependent init: run ``x`` (a (batch, dim) draw from the
    base or the data) through the flow front to back, re-initializing
    every ActNorm so that its output over the batch has zero mean and
    unit variance per dimension. The top-level `Chain` may hold a
    `Repeated` of `GlowBlock`s (the activations threaded block to block),
    bare `GlowBlock`s and bare `ActNorm`s; ActNorms nested elsewhere are
    not reached, and a flow with none raises ValueError. Each new layer
    keeps the replaced one's parameter dtype. The flow is updated in
    place (its ActNorm parameters are copied into) and returned: the JAX
    package returns a new flow. ``x`` is cast to the flow's dtype first
    (JAX promotes instead; torch's matmuls take one dtype)."""
    params = list(flow.bijector.parameters())
    if params:
        x = x.to(params[0].dtype)

    def init(an: ActNorm, x):
        new = ActNorm.initialize(x, dtype=an.log_scale.dtype)
        an.log_scale.copy_(new.log_scale)
        an.shift.copy_(new.shift)

    def init_block(block: GlowBlock, x):
        init(block.actnorm, x)
        return block.forward_and_log_det(x)[0]

    n_found = 0
    for b in flow.bijector.bijectors:
        if isinstance(b, Repeated) and all(isinstance(s, GlowBlock)
                                           for s in b.stacked):
            for block in b.stacked:
                x = init_block(block, x)
            n_found += b.n
        elif isinstance(b, GlowBlock):
            x = init_block(b, x)
            n_found += 1
        elif isinstance(b, ActNorm):
            init(b, x)
            x = b.forward_and_log_det(x)[0]
            n_found += 1
        else:
            x = b.forward_and_log_det(x)[0]
    if n_found == 0:
        raise ValueError(
            "glow_init_actnorms found no ActNorm/GlowBlock at the top level "
            "of the flow's Chain; nested ActNorms are not reached")
    return flow
