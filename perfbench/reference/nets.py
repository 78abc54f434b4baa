"""The conditioner networks of the plain reference: Dense chains
``act(x @ W + b)`` with W stored (in, out), leaky ReLU (slope 0.01)
between layers (Flux's defaults, which NormalizingFlows.jl's `fnn`
takes)."""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch

from .precision import matmul

BIAS_SCALE = 0.1

# while a `branches` block runs: [masks, the next to take or None]
_BRANCHES: list | None = None


@contextlib.contextmanager
def branches(taken: list | None = None):
    """Inside the block, each leaky ReLU records its branch (h >= 0) in
    the list yielded; with ``taken`` (a list an earlier block recorded),
    each takes the branch recorded at its turn instead, in call order."""
    global _BRANCHES
    outer, _BRANCHES = _BRANCHES, ([] if taken is None else taken,
                                   None if taken is None else iter(taken))
    try:
        yield _BRANCHES[0]
    finally:
        _BRANCHES = outer


def leaky_relu(h: torch.Tensor) -> torch.Tensor:
    if _BRANCHES is None:
        on = h >= 0
    elif _BRANCHES[1] is None:
        on = h >= 0
        _BRANCHES[0].append(on)
    else:
        on = next(_BRANCHES[1])
    return torch.where(on, h, 0.01 * h)


def dense_leaves(prefix: str, widths, last_scale: float = 1.0) -> list:
    """(name, shape, scale) of a Dense chain's weights: W uniform in
    ±sqrt(6 / (in + out)) (Glorot), b uniform in ±BIAS_SCALE, so that no
    layer starts as the identity; the last layer's both times
    ``last_scale``."""
    out = []
    last = len(widths) - 2
    for li, (din, dout) in enumerate(zip(widths[:-1], widths[1:])):
        k = last_scale if li == last else 1.0
        out.append((f"{prefix}.l{li}.W", (din, dout),
                    k * math.sqrt(6.0 / (din + dout))))
        out.append((f"{prefix}.l{li}.b", (dout,), k * BIAS_SCALE))
    return out


def mlp(weights: dict, prefix: str, x: torch.Tensor, depth: int,
        precision: str, out_act: Callable | None = None) -> torch.Tensor:
    h = x
    for li in range(depth):
        h = matmul(h, weights[f"{prefix}.l{li}.W"], precision) \
            + weights[f"{prefix}.l{li}.b"]
        if li < depth - 1:
            h = leaky_relu(h)
        elif out_act is not None:
            h = out_act(h)
    return h


def interleave(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """out[..., 0::2] = first, out[..., 1::2] = second."""
    d = first.shape[-1] + second.shape[-1]
    out = first.new_empty(first.shape[:-1] + (d,))
    out = out.index_copy(-1, torch.arange(0, d, 2, device=out.device), first)
    return out.index_copy(-1, torch.arange(1, d, 2, device=out.device),
                          second)


def split_sizes(d: int) -> tuple[int, int]:
    """(dims of the even coupling's transformed set 0::2, of the odd's
    1::2)."""
    return (d + 1) // 2, d // 2
