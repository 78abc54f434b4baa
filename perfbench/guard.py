"""The run's guard against JAX: the port is measured alone.

`forbidden` compares the top-level name of each loaded module (the part
before the first dot) whole, so ``normalizingflows_torch`` passes where
``normalizingflows`` (the JAX package) does not."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "normalizingflows")


def forbidden(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
