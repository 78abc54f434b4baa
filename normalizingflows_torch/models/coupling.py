"""RealNVP affine-coupling flow.

Counterpart of `normalizingflows/jl_tpu/models/coupling.py`:

* `AffineCoupling`: y_A = x_A ⊙ exp(s(x_B)) + t(x_B), log|det J| = Σ s(x_B);
  the inverse x_A = (y_A − t(y_B)) ⊙ exp(−s(y_B)). The log-scale net ``s``
  ends in tanh before the exponential.
* `RealNVP_layer`: two couplings with complementary alternating masks.
* `CouplingPairStack`: N such blocks with the split carry of the JAX scan:
  partition once into (even, odd) streams, run the blocks in a Python loop
  over per-block conditioners, riffle once at the end.
* `realnvp`: defaults hdims=(32, 32), nlayers=10. ``fused=True`` runs the
  whole stack through the fused coupling kernels
  (`experimental.fused_flow.FusedRealNVP`, imported lazily).

Every constructor builds on ``device``; None is the card, and raises where
there is no CUDA device. The default path runs no hand-written kernel: its
conditioner matmuls go to cuBLAS.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.masks import PartitionMask, interleave
from ..utils.device import resolve_device
from .bijector import Bijector
from .distributions import DiagNormal, Distribution, TransformedDistribution
from .flows import create_flow
from .nets import MLP, fnn

__all__ = ["AffineCoupling", "CouplingPairStack", "RealNVP_layer", "realnvp"]

_NETS = ("s_even", "t_even", "s_odd", "t_odd")


class AffineCoupling(Bijector):
    """Affine coupling layer (Dinh et al. 2017, RealNVP)."""

    def __init__(self, s: MLP, t: MLP, mask: PartitionMask):
        super().__init__()
        self.s, self.t, self.mask = s, t, mask

    @staticmethod
    def make(generator, dim, hdims, mask_idx, dtype=torch.float32,
             device=None, compute_dtype=None) -> "AffineCoupling":
        """The conditioners map the complement (size dim − |A|) to the
        transformed set (size |A|); ``s`` gets a tanh output activation.
        ``s`` is drawn from the generator before ``t``. ``compute_dtype``
        sets the conditioners' bf16 policy (`nets.Dense`)."""
        device = resolve_device(device)
        mask = PartitionMask.make(dim, mask_idx)
        c = mask.n_transformed
        s = fnn(generator, dim - c, hdims, c, output_activation=torch.tanh,
                dtype=dtype, device=device, compute_dtype=compute_dtype)
        t = fnn(generator, dim - c, hdims, c, dtype=dtype, device=device,
                compute_dtype=compute_dtype)
        return AffineCoupling(s, t, mask)

    def forward_and_log_det(self, x):
        x_a, x_b, x_c = self.mask.partition(x)
        log_s = self.s(x_b)
        y_a = x_a * torch.exp(log_s) + self.t(x_b)
        return self.mask.combine(y_a, x_b, x_c), log_s.sum(dim=-1)

    def inverse_and_log_det(self, y):
        y_a, y_b, y_c = self.mask.partition(y)
        log_s = self.s(y_b)
        x_a = (y_a - self.t(y_b)) * torch.exp(-log_s)
        return self.mask.combine(x_a, y_b, y_c), -log_s.sum(dim=-1)


def RealNVP_layer(generator, dim, hdims, dtype=torch.float32,
                  device=None, compute_dtype=None) -> list[AffineCoupling]:
    """One RealNVP block: two couplings with complementary alternating masks
    (reference `realnvp.jl:132-145`, masks `1:2:d` and `2:2:d`)."""
    device = resolve_device(device)
    return [AffineCoupling.make(generator, dim, hdims, range(parity, dim, 2),
                                dtype, device, compute_dtype)
            for parity in (0, 1)]


class CouplingPairStack(Bijector):
    """N RealNVP blocks (complementary even/odd `AffineCoupling` pairs)
    with a split carry: partition once into (x_even, x_odd), run the
    blocks, riffle once. ``stacked[name][i]`` for name in ``s_even``,
    ``t_even``, ``s_odd``, ``t_odd`` is block i's conditioner (the JAX
    package stacks them along a leading axis for `lax.scan`; here a Python
    loop walks the lists). ``remat=True`` recomputes each block's
    activations in the backward pass (`torch.utils.checkpoint`, the
    counterpart of `jax.checkpoint` on the scan body)."""

    def __init__(self, s_even: Sequence[MLP], t_even: Sequence[MLP],
                 s_odd: Sequence[MLP], t_odd: Sequence[MLP], dim: int,
                 remat: bool = False):
        super().__init__()
        nets = (s_even, t_even, s_odd, t_odd)
        if len({len(n) for n in nets}) != 1:
            raise ValueError("one s and one t conditioner per coupling")
        self.stacked = nn.ModuleDict({k: nn.ModuleList(v)
                                      for k, v in zip(_NETS, nets)})
        self.dim, self.remat = int(dim), bool(remat)

    @staticmethod
    def from_pairs(pairs, remat: bool = False) -> "CouplingPairStack":
        """Build from `RealNVP_layer` output: a list of ``[c_even, c_odd]``
        pairs whose masks must be the alternating ``0::2`` / ``1::2`` sets."""
        dim = pairs[0][0].mask.dim
        even, odd = tuple(range(0, dim, 2)), tuple(range(1, dim, 2))
        for c_e, c_o in pairs:
            if c_e.mask.idx_a != even or c_o.mask.idx_a != odd:
                raise ValueError(
                    "CouplingPairStack requires alternating even/odd masks; "
                    "use a Chain of couplings for other masks")
        return CouplingPairStack([p[0].s for p in pairs],
                                 [p[0].t for p in pairs],
                                 [p[1].s for p in pairs],
                                 [p[1].t for p in pairs], dim, remat)

    def _blocks(self):
        return zip(*(self.stacked[k] for k in _NETS))

    def _run(self, body, carry, blocks):
        for nets in blocks:
            if self.remat:
                carry = checkpoint(body, *carry, *nets, use_reentrant=False)
            else:
                carry = body(*carry, *nets)
        return carry

    def forward_and_log_det(self, x):
        def body(xa, xb, ld, s_e, t_e, s_o, t_o):
            s = s_e(xb)
            xa = xa * torch.exp(s) + t_e(xb)
            s2 = s_o(xa)
            xb = xb * torch.exp(s2) + t_o(xa)
            return xa, xb, ld + s.sum(dim=-1) + s2.sum(dim=-1)

        xa, xb, ld = self._run(body, (x[..., 0::2], x[..., 1::2],
                                      x.new_zeros(x.shape[:-1])),
                               list(self._blocks()))
        return interleave(xa, xb, self.dim), ld

    def inverse_and_log_det(self, y):
        def body(ya, yb, ld, s_e, t_e, s_o, t_o):
            s2 = s_o(ya)
            yb = (yb - t_o(ya)) * torch.exp(-s2)
            s = s_e(yb)
            ya = (ya - t_e(yb)) * torch.exp(-s)
            return ya, yb, ld - s.sum(dim=-1) - s2.sum(dim=-1)

        ya, yb, ld = self._run(body, (y[..., 0::2], y[..., 1::2],
                                      y.new_zeros(y.shape[:-1])),
                               list(self._blocks())[::-1])
        return interleave(ya, yb, self.dim), ld


def realnvp(
    generator: torch.Generator,
    q0: Distribution | int,
    hdims: Sequence[int] = (32, 32),
    nlayers: int = 10,
    dtype=torch.float32,
    device=None,
    fused: bool = False,
    compute_dtype=None,
    remat: bool = False,
) -> TransformedDistribution:
    """RealNVP flow (reference `realnvp.jl:170-192`); ``q0`` may be a base
    distribution or an int dim (a standard `DiagNormal` base). Defaults
    hdims=(32, 32), nlayers=10 (Agrawal–Sheldon–Domke 2020, App. E).

    The blocks form one split-carry `CouplingPairStack` (JAX's default
    ``scan=True``; its ``scan=False`` layout, a `Chain` of per-block
    ``Chain(RealNVP_layer(...))``, a caller builds directly).
    ``fused=True`` runs the whole stack through the fused coupling kernels
    (`experimental.FusedRealNVP`); one generator seed gives the fused and
    the unfused flow the same weights. The flag stays the caller's: it sets
    the parameter tree (stacked ``groups`` or per-block conditioners), so
    a flow's `state_dict` and the JAX flow `load_jax_params` takes must
    not change with the device or the shape. ``remat=True`` recomputes
    block activations in the backward pass. ``compute_dtype=torch.bfloat16``
    is the bf16 policy of the conditioners' products (`nets.Dense`; with
    ``fused=True`` the kernels' policy instantiations); ``dtype=
    torch.bfloat16`` stores the parameters in bfloat16."""
    device = resolve_device(device)
    if isinstance(q0, int):
        q0 = DiagNormal.standard(q0, dtype, device)
    pairs = [RealNVP_layer(generator, q0.event_dim, hdims, dtype, device,
                           compute_dtype) for _ in range(nlayers)]
    if fused:
        from ..experimental import FusedRealNVP

        return create_flow([FusedRealNVP.from_blocks(
            pairs, compute_dtype=compute_dtype)], q0)
    return create_flow([CouplingPairStack.from_pairs(pairs, remat=remat)], q0)
