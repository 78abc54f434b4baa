"""`FusedRealNVP` and `train_realnvp_fused`: a whole RealNVP stack through
the fused coupling kernels, and its whole training run through one kernel.

Counterpart of `normalizingflows/jl_tpu/experimental/fused_flow.py`.
`FusedRealNVP` runs the stack through K4/K5 (`coupling_cuda`);
`train_realnvp_fused` trains it by reverse KL with Adam through K6, one
launch per chunk of steps (`train_cuda`). `realnvp(..., fused=True)`
imports this module lazily.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.bijector import Bijector
from ..models.distributions import DiagNormal
from ..models.nets import _check_compute_dtype
from ..train import TrainResult, TrainState, _host
from .coupling_cuda import BACKENDS, _leaves, coupling_stack_fused

__all__ = ["FusedRealNVP", "train_realnvp_fused"]


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
    blocks of `realnvp(fused=False)`. ``compute_dtype=torch.bfloat16``
    runs the kernels' bf16-policy instantiations (the conditioner products'
    operands rounded to bfloat16, float32 sums); bfloat16 weights run the
    bfloat16-storage ones."""

    def __init__(self, groups: nn.ModuleDict, idx_even, idx_odd,
                 backend: str = "auto", compute_dtype=None):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        _check_compute_dtype(compute_dtype)
        self.groups = groups
        self.idx_even = tuple(int(i) for i in idx_even)
        self.idx_odd = tuple(int(i) for i in idx_odd)
        self.backend = backend
        self.compute_dtype = compute_dtype

    @staticmethod
    def from_blocks(blocks, backend: str = "auto",
                    compute_dtype=None) -> "FusedRealNVP":
        """Build from a list of ``[c_even, c_odd]`` `AffineCoupling` pairs
        (as `RealNVP_layer` makes them), stacking weights across blocks."""
        groups = nn.ModuleDict({
            grp: nn.ModuleDict({
                "s": _stacked([b[k].s for b in blocks]),
                "t": _stacked([b[k].t for b in blocks]),
            }) for k, grp in enumerate(("even", "odd"))})
        return FusedRealNVP(groups, blocks[0][0].mask.idx_a,
                            blocks[0][1].mask.idx_a, backend, compute_dtype)

    def forward_and_log_det(self, x):
        return coupling_stack_fused(x, self.groups, self.idx_even,
                                    self.idx_odd, inverse=False,
                                    backend=self.backend,
                                    compute_dtype=self.compute_dtype)

    def inverse_and_log_det(self, y):
        return coupling_stack_fused(y, self.groups, self.idx_even,
                                    self.idx_odd, inverse=True,
                                    backend=self.backend,
                                    compute_dtype=self.compute_dtype)


def train_realnvp_fused(generator, flow, target, n_samples: int,
                        max_iters: int = 1000, learning_rate: float = 5e-4,
                        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                        chunk: int = 512) -> TrainResult:
    """ELBO-train a fused RealNVP flow with the whole-run kernel K6.

    Draws every step's ``n_samples`` base samples up front from
    ``generator`` (on the flow's device), then runs all ``max_iters`` Adam
    steps in launches of ``chunk`` steps (`train_cuda.
    adam_train_realnvp_fused`): one launch per 512 steps by default, with
    the host out of the loop. Same math as ``train_flow(generator,
    elbo_batch, flow, target.log_prob, n_samples)`` with
    ``torch.optim.Adam(lr=learning_rate)`` and the base frozen.

    Requirements: ``flow`` built with ``realnvp(..., fused=True)``, a
    `DiagNormal` base, and ``target`` an `nft.Banana`, `nft.Funnel` or
    `nft.WarpedGauss` of the flow's dimension (or its ``log_prob``): K6
    evaluates the target's log-density and gradient itself, as JAX's
    kernel does for these built-ins; any other target raises before a
    step. The flow's `FusedRealNVP` backend decides where the run goes
    ("auto": K6 for a flow on the card, the plain version for one on the
    CPU). The flow is trained in place: `TrainResult.flow` is the module
    passed in; its state holds no optimizer. A flow under the bf16
    ``compute_dtype`` policy trains in float32, as JAX's K6 does (its
    trainer takes no compute dtype), and keeps its policy. A flow of
    bfloat16 weights trains on K6's bfloat16 entry (float32 arithmetic,
    each stored value rounded once a step, Adam's bias corrections in
    float32); its losses come back widened to float32.
    """
    from .train_cuda import adam_train_realnvp_fused

    bijectors = getattr(flow.bijector, "bijectors", (flow.bijector,))
    if len(bijectors) != 1 or not isinstance(bijectors[0], FusedRealNVP):
        raise ValueError(
            "train_realnvp_fused requires a flow built with "
            "realnvp(..., fused=True); got " + type(flow.bijector).__name__)
    if not isinstance(flow.base, DiagNormal):
        raise ValueError("train_realnvp_fused requires a DiagNormal base")
    fb = bijectors[0]
    with torch.no_grad():
        xs = flow.base.sample(generator, (max_iters, n_samples))
        groups, losses = adam_train_realnvp_fused(
            xs, fb.groups, fb.idx_even, fb.idx_odd, target, flow.base.loc,
            flow.base.scale, learning_rate, b1=b1, b2=b2, eps=eps,
            chunk=chunk, backend=fb.backend)
        for p, new in zip(_leaves(fb.groups), _leaves(groups)):
            p.copy_(new)
    stats = {"iteration": np.arange(1, max_iters + 1),
             "loss": _host(losses)}
    return TrainResult(flow, stats, TrainState(flow, None, max_iters))
