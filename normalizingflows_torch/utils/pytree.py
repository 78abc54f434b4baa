"""Trainable-parameter selection and gradient norm.

Counterpart of the parts of `normalizingflows/jl_tpu/utils/pytree.py` the
training loop uses: the JAX package freezes the base distribution with a
boolean mask over the flow pytree (`trainable_mask` + `apply_mask`); here
the base's parameters stop requiring gradients and stay out of the
optimizer.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

__all__ = ["trainable_parameters", "global_norm"]


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
