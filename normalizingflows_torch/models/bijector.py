"""Bijector protocol, combinators and the elementwise affine maps.

Counterpart of `normalizingflows/jl_tpu/models/bijector.py`. Tensors are
row-major batches ``(..., dim)``; ``forward_and_log_det`` /
``inverse_and_log_det`` return ``(out, log_det)`` with ``log_det`` shaped
like the batch ``(...,)``. ``Chain([f, g])`` applies ``f`` first.
`Repeated` keeps its blocks in a list where the JAX package stacks their
leaves along a leading axis for `lax.scan`; the weight bridge splits that
axis across the list.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.masks import cached_index

__all__ = ["Bijector", "Identity", "Inverse", "Chain", "Shift", "Scale",
           "Stacked", "Repeated", "invert", "chain", "stack_bijectors"]


def _zero_log_det(x: torch.Tensor) -> torch.Tensor:
    return x.new_zeros(x.shape[:-1])


class Bijector(nn.Module):
    """Invertible transform with tractable log|det J|. ``forward(x)`` (and
    so calling the module) returns the transformed tensor alone."""

    def forward_and_log_det(self, x: torch.Tensor):
        raise NotImplementedError

    def inverse_and_log_det(self, y: torch.Tensor):
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_and_log_det(x)[0]

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return self.inverse_and_log_det(y)[0]


class Identity(Bijector):
    """y = x, log|det J| = 0."""

    def forward_and_log_det(self, x):
        return x, _zero_log_det(x)

    def inverse_and_log_det(self, y):
        return y, _zero_log_det(y)


class Inverse(Bijector):
    """The inverse of another bijector."""

    def __init__(self, bijector: Bijector):
        super().__init__()
        self.bijector = bijector

    def forward_and_log_det(self, x):
        return self.bijector.inverse_and_log_det(x)

    def inverse_and_log_det(self, y):
        return self.bijector.forward_and_log_det(y)


def invert(b: Bijector) -> Bijector:
    """Invert a bijector, collapsing double inversion."""
    if isinstance(b, Inverse):
        return b.bijector
    return Inverse(b)


class Chain(Bijector):
    """Composition; ``bijectors[0]`` is applied FIRST in the forward pass."""

    def __init__(self, bijectors: Sequence[Bijector]):
        super().__init__()
        self.bijectors = nn.ModuleList(bijectors)

    def forward_and_log_det(self, x):
        log_det = _zero_log_det(x)
        for b in self.bijectors:
            x, ld = b.forward_and_log_det(x)
            log_det = log_det + ld
        return x, log_det

    def inverse_and_log_det(self, y):
        log_det = _zero_log_det(y)
        for b in reversed(self.bijectors):
            y, ld = b.inverse_and_log_det(y)
            log_det = log_det + ld
        return y, log_det


def chain(*bijectors: Bijector) -> Chain:
    return Chain(bijectors)


class Repeated(Bijector):
    """N structurally identical blocks applied in turn; block 0 first in
    the forward pass, the last first in the inverse. ``stacked`` is an
    `nn.ModuleList`, so the JAX path ``.stacked.<leaf>`` (the leaf with a
    leading layer axis) loads through the weight bridge. ``remat=True``
    recomputes each block's activations in the backward pass
    (`torch.utils.checkpoint`, the counterpart of `jax.checkpoint` on the
    scan body)."""

    def __init__(self, blocks: Sequence[Bijector], remat: bool = False):
        super().__init__()
        self.stacked = nn.ModuleList(blocks)
        self.remat = bool(remat)

    @property
    def n(self) -> int:
        return len(self.stacked)

    def _run(self, x, fn_name, blocks):
        log_det = _zero_log_det(x)
        for block in blocks:
            fn = getattr(block, fn_name)
            if self.remat:
                x, ld = checkpoint(fn, x, use_reentrant=False)
            else:
                x, ld = fn(x)
            log_det = log_det + ld
        return x, log_det

    def forward_and_log_det(self, x):
        return self._run(x, "forward_and_log_det", self.stacked)

    def inverse_and_log_det(self, y):
        return self._run(y, "inverse_and_log_det", reversed(self.stacked))


def stack_bijectors(blocks: Sequence[Bijector],
                    remat: bool = False) -> Repeated:
    """`Repeated` of structurally identical bijectors (``remat``: see
    `Repeated`)."""
    return Repeated(list(blocks), remat)


class Shift(Bijector):
    """y = x + b (Bijectors.jl `Shift`; the mean-field flow's location)."""

    def __init__(self, b: torch.Tensor):
        super().__init__()
        self.b = nn.Parameter(b)

    def forward_and_log_det(self, x):
        return x + self.b, _zero_log_det(x)

    def inverse_and_log_det(self, y):
        return y - self.b, _zero_log_det(y)


class Scale(Bijector):
    """y = a ⊙ x with log|det J| = Σ log|a| (Bijectors.jl `Scale`). No
    positivity constraint on ``a``: the log-det takes log|a|, so a sign
    flip stays a valid bijection, as in the reference."""

    def __init__(self, a: torch.Tensor):
        super().__init__()
        self.a = nn.Parameter(a)

    def _log_det(self, x):
        ld = torch.log(torch.abs(self.a)).sum()
        return ld.expand(x.shape[:-1]).to(x.dtype)

    def forward_and_log_det(self, x):
        return x * self.a, self._log_det(x)

    def inverse_and_log_det(self, y):
        return y / self.a, -self._log_det(y)


class Stacked(Bijector):
    """Different bijectors on disjoint index sets of the last axis
    (Bijectors.jl `Stacked((b1, b2), [r1, r2])`; the Hamiltonian flow's
    momentum layer). A 2-tuple range is a ``(start, stop)`` span; any other
    sequence (a list, a ``range``, a tuple of another length) is taken as
    the index set itself, so a two-element index set is a list
    (``[0, 2]``). The sets must be non-empty, pairwise disjoint and tile
    [0, dim). Spans in order are slices and a concatenation; other sets
    are one gather a bijector and one gather back, whose index tensors are
    made once a device."""

    def __init__(self, bijectors: Sequence[Bijector], ranges: Sequence):
        super().__init__()
        self.bijectors = nn.ModuleList(bijectors)
        sets = []
        for r in ranges:
            if isinstance(r, tuple) and len(r) == 2:
                r = range(int(r[0]), int(r[1]))
            sets.append(tuple(int(i) for i in r))
        self.index_sets = tuple(sets)
        if len(self.bijectors) != len(sets):
            raise ValueError("bijectors and ranges must have equal length")
        if any(not idx for idx in sets):
            raise ValueError(f"Stacked index sets must not be empty; got "
                             f"{self.index_sets}")
        flat = [i for idx in sets for i in idx]
        if sorted(flat) != list(range(len(flat))):
            raise ValueError(
                "Stacked index sets must be disjoint and tile [0, dim); "
                f"got {self.index_sets}")
        self.spans = flat == list(range(len(flat))) and all(
            idx == tuple(range(idx[0], idx[-1] + 1)) for idx in sets)
        # where each output column comes from in the parts' concatenation
        self._order = tuple(sorted(range(len(flat)), key=flat.__getitem__))
        self._indices: dict = {}

    def _apply(self, x, fn_name):
        parts, log_det = [], _zero_log_det(x)
        for b, idx in zip(self.bijectors, self.index_sets):
            part = (x[..., idx[0]:idx[-1] + 1] if self.spans else
                    x.index_select(-1, cached_index(self._indices, idx,
                                                    x.device)))
            part, ld = getattr(b, fn_name)(part)
            parts.append(part)
            log_det = log_det + ld
        out = torch.cat(parts, dim=-1)
        if not self.spans:
            out = out.index_select(-1, cached_index(
                self._indices, self._order, x.device))
        return out, log_det

    def forward_and_log_det(self, x):
        return self._apply(x, "forward_and_log_det")

    def inverse_and_log_det(self, y):
        return self._apply(y, "inverse_and_log_det")
