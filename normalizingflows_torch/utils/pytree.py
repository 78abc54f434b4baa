"""Trainable-parameter selection, gradient norm, size and flattening.

Counterpart of the parts of `normalizingflows/jl_tpu/utils/pytree.py` the
port needs: the JAX package freezes the base distribution with a
boolean mask over the flow pytree (`trainable_mask` + `apply_mask`); here
the base's parameters stop requiring gradients and stay out of the
optimizer. A module's array leaves are its parameters and buffers.
"""

from __future__ import annotations

import copy
from typing import Callable, Iterable

import torch
from torch import nn

__all__ = ["trainable_parameters", "global_norm", "tree_size",
           "destructure"]


def trainable_parameters(flow: nn.Module,
                         train_base: bool = False) -> list[nn.Parameter]:
    """The parameters to optimise. Unless ``train_base``, the parameters of
    ``flow.base`` (if the module has one) are frozen: their
    ``requires_grad`` is set to False and they are left out."""
    base = getattr(flow, "base", None)
    if isinstance(base, nn.Module):
        base.requires_grad_(train_base)
    return [p for p in flow.parameters() if p.requires_grad]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all tensors together (the reference reports `norm(g)`
    per step, `src/optimize.jl:89`). Stays on the tensors' device."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def tree_size(module: nn.Module) -> int:
    """Total number of scalars in a module's parameters and buffers."""
    return sum(t.numel() for t in (*module.parameters(), *module.buffers()))


def destructure(module: nn.Module
                ) -> tuple[torch.Tensor, Callable[[torch.Tensor], nn.Module]]:
    """``(theta, re)``: the parameters flattened into one vector (detached,
    in `named_parameters` order) and ``re(theta)``, a copy of ``module``
    with its parameters read from ``theta``; API parity with
    `Optimisers.destructure` (reference `src/NormalizingFlows.jl:67`), for
    diagnostics and interop: the trainers optimise the module itself."""
    params = list(module.parameters())
    theta = (torch.cat([p.detach().reshape(-1) for p in params]) if params
             else torch.zeros((0,)))

    def re(theta: torch.Tensor) -> nn.Module:
        if theta.numel() != sum(p.numel() for p in params):
            raise ValueError(f"theta has {theta.numel()} entries, the module "
                             f"{sum(p.numel() for p in params)} parameters")
        out = copy.deepcopy(module)
        with torch.no_grad():
            at = 0
            for p in out.parameters():
                p.copy_(theta[at:at + p.numel()].reshape(p.shape))
                at += p.numel()
        return out

    return theta, re
