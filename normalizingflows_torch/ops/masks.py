"""Static partition masks for coupling layers.

Counterpart of `normalizingflows/jl_tpu/ops/masks.py`. Set naming follows
Bijectors.jl: A = transformed dims, B = dims fed to the conditioner, C =
passthrough dims (empty for the standard coupling masks). Index sets are
fixed at construction; an evenly strided set is taken as a strided slice
(a view) rather than a gather. Another set is gathered and scattered
through an index tensor made once per device, so that a call after the
first copies nothing from the host (and can be captured in a CUDA graph).
"""

from __future__ import annotations

import torch

__all__ = ["PartitionMask", "interleave", "cached_index"]


def cached_index(cache: dict, idx: tuple[int, ...], device) -> torch.Tensor:
    """``idx`` as a long tensor on ``device``, made once and kept in
    ``cache`` (keyed by index set and device): later calls copy nothing
    from the host."""
    key = (idx, device)
    if key not in cache:
        cache[key] = torch.tensor(idx, dtype=torch.long, device=device)
    return cache[key]


def _as_strided(idx: tuple[int, ...], dim: int):
    """``(start, step)`` if ``idx`` equals ``range(start, dim, step)``,
    else None (then a gather is used)."""
    if not idx:
        return None
    start = idx[0]
    if len(idx) == 1:
        # any step > dim-1-start reproduces the single element; prefer 2 so
        # the d=2 alternating masks keep the riffle-combine fast path
        if start >= dim:
            return None
        step = 2 if start + 2 >= dim else dim - start
        return start, step
    step = idx[1] - idx[0]
    if step > 0 and idx == tuple(range(start, dim, step)):
        return start, step
    return None


def interleave(first: torch.Tensor, second: torch.Tensor,
               dim: int) -> torch.Tensor:
    """Riffle two last-axis tensors: out[..., 0::2] = first,
    out[..., 1::2] = second. ``dim`` may be odd (first one longer)."""
    n1, n2 = first.shape[-1], second.shape[-1]
    if n2 < n1:  # odd dim: pad the shorter stream, slice the tail off
        second = torch.nn.functional.pad(second, (0, n1 - n2))
    out = torch.stack([first, second], dim=-1)
    return out.reshape(*first.shape[:-1], 2 * n1)[..., :dim]


class PartitionMask:
    """Split (..., dim) into (x_A, x_B, x_C) and put it back together."""

    def __init__(self, dim: int, idx_a, idx_b, idx_c=()):
        self.dim = int(dim)
        self.idx_a = tuple(int(i) for i in idx_a)  # transformed
        self.idx_b = tuple(int(i) for i in idx_b)  # conditioner input
        self.idx_c = tuple(int(i) for i in idx_c)  # passthrough
        self._indices: dict = {}  # (index set, device) -> index tensor

    @staticmethod
    def make(dim: int, idx_a) -> "PartitionMask":
        """PartitionMask(dim, A) with B = complement, C = ∅."""
        idx_a = tuple(int(i) for i in idx_a)
        in_a = set(idx_a)
        return PartitionMask(dim, idx_a,
                             tuple(i for i in range(dim) if i not in in_a))

    @staticmethod
    def alternating(dim: int, parity: int) -> "PartitionMask":
        """Even (parity=0) or odd (parity=1) strided mask."""
        return PartitionMask.make(dim, range(parity, dim, 2))

    @property
    def n_transformed(self) -> int:
        return len(self.idx_a)

    @property
    def n_conditioned(self) -> int:
        return len(self.idx_b)

    def _take(self, x: torch.Tensor, idx: tuple[int, ...]) -> torch.Tensor:
        if not idx:
            return x[..., :0]
        s = _as_strided(idx, self.dim)
        if s is not None:
            start, step = s
            return x[..., start::step]
        return x[..., cached_index(self._indices, idx, x.device)]

    def partition(self, x: torch.Tensor):
        """Split (..., dim) into (x_A, x_B, x_C)."""
        return (self._take(x, self.idx_a), self._take(x, self.idx_b),
                self._take(x, self.idx_c))

    def combine(self, x_a, x_b, x_c) -> torch.Tensor:
        """Reassemble (..., dim) from parts: a riffle for the alternating
        even/odd pair, a scatter for other index sets."""
        sa = _as_strided(self.idx_a, self.dim)
        sb = _as_strided(self.idx_b, self.dim)
        if (not self.idx_c and sa is not None and sb is not None
                and sa[1] == 2 and sb[1] == 2 and {sa[0], sb[0]} == {0, 1}):
            first, second = (x_a, x_b) if sa[0] == 0 else (x_b, x_a)
            return interleave(first, second, self.dim)
        out = x_a.new_zeros(x_a.shape[:-1] + (self.dim,))
        for idx, part in ((self.idx_a, x_a), (self.idx_b, x_b),
                          (self.idx_c, x_c)):
            if idx:
                out = out.index_copy(
                    -1, cached_index(self._indices, idx, out.device), part)
        return out
