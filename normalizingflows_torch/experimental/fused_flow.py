"""`FusedRealNVP`: a whole RealNVP stack through the fused coupling kernels.

Counterpart of `normalizingflows/jl_tpu/experimental/fused_flow.py` without
`train_realnvp_fused`, whose whole-run kernel is not ported yet.
`realnvp(..., fused=True)` imports this module lazily.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.bijector import Bijector
from .coupling_cuda import BACKENDS, coupling_stack_fused

__all__ = ["FusedRealNVP"]


def _stacked(mlps) -> nn.ModuleList:
    """One ``ParameterList([W, b])`` per layer, each stacked over blocks:
    W (n_blocks, in, out), b (n_blocks, out)."""
    return nn.ModuleList(
        nn.ParameterList([
            nn.Parameter(torch.stack([m.layers[li].W.detach() for m in mlps])),
            nn.Parameter(torch.stack([m.layers[li].b.detach() for m in mlps])),
        ]) for li in range(len(mlps[0].layers)))


class FusedRealNVP(Bijector):
    """RealNVP blocks applied by one K4 launch (and one K5 call in the
    backward). ``groups['even'|'odd']['s'|'t'][layer]`` holds
    ``[W, b]`` stacked over blocks, the layout of the JAX ``groups``
    pytree, so the kernels read contiguous stacks and JAX parameters load
    by their own paths (`utils.bridge.load_jax_params`). Mathematically the
    blocks of `realnvp(fused=False)`."""

    def __init__(self, groups: nn.ModuleDict, idx_even, idx_odd,
                 backend: str = "auto"):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        self.groups = groups
        self.idx_even = tuple(int(i) for i in idx_even)
        self.idx_odd = tuple(int(i) for i in idx_odd)
        self.backend = backend

    @staticmethod
    def from_blocks(blocks, backend: str = "auto") -> "FusedRealNVP":
        """Build from a list of ``[c_even, c_odd]`` `AffineCoupling` pairs
        (as `RealNVP_layer` makes them), stacking weights across blocks."""
        groups = nn.ModuleDict({
            grp: nn.ModuleDict({
                "s": _stacked([b[k].s for b in blocks]),
                "t": _stacked([b[k].t for b in blocks]),
            }) for k, grp in enumerate(("even", "odd"))})
        return FusedRealNVP(groups, blocks[0][0].mask.idx_a,
                            blocks[0][1].mask.idx_a, backend)

    def forward_and_log_det(self, x):
        return coupling_stack_fused(x, self.groups, self.idx_even,
                                    self.idx_odd, inverse=False,
                                    backend=self.backend)

    def inverse_and_log_det(self, y):
        return coupling_stack_fused(y, self.groups, self.idx_even,
                                    self.idx_odd, inverse=True,
                                    backend=self.backend)
