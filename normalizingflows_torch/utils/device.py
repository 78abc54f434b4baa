"""Where the port's constructors put their tensors.

The port runs on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and without CUDA such a call raises rather
than build on the CPU. Tests and CPU runs pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a `torch.device`; ``None`` is the current CUDA device,
    and raises where there is no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds on the card by default; pass "
            "device='cpu' to build on the CPU")
    return torch.device("cuda")
