"""Flow composition (counterpart of `jl_tpu/models/flows.py`)."""

from __future__ import annotations

from typing import Sequence

from .bijector import Bijector, Chain
from .distributions import Distribution, TransformedDistribution

__all__ = ["create_flow"]


def create_flow(layers: Sequence[Bijector],
                q0: Distribution) -> TransformedDistribution:
    """Compose ``layers`` (applied first to last) on base ``q0``."""
    return TransformedDistribution(q0, Chain(layers))
