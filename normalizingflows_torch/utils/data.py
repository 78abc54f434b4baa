"""Data loading for forward-KL (maximum-likelihood) training.

The port's own copy of `normalizingflows/jl_tpu/utils/data.py`'s numpy
path: `NumpyLoader` (shuffled minibatches of an in-memory array; from one
seed it yields the JAX package's batches exactly), `make_loader` (arrays and
``.npy``/``.npz`` files) and `to_raw_file`. The C++ prefetching loader over
raw float32 files (`NativeLoader`) is not ported yet: `make_loader` raises
for such a path instead of reading it with numpy.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["NumpyLoader", "to_raw_file", "make_loader"]


def to_raw_file(path: str, data) -> str:
    """Write (n, dim) float32 row-major raw file (the native loader's
    format)."""
    arr = np.ascontiguousarray(np.asarray(data, dtype=np.float32))
    if arr.ndim != 2:
        raise ValueError("data must be (n_rows, dim)")
    arr.tofile(path)
    return path


class NumpyLoader:
    """Shuffled minibatches of an (n_rows, dim) array, as float32. Each
    epoch walks a fresh permutation from ``np.random.default_rng(seed)``;
    a batch may span two epochs."""

    def __init__(self, data, batch: int, seed: int = 0):
        self.data = np.asarray(data, dtype=np.float32)
        if self.data.ndim != 2:
            raise ValueError("data must be (n_rows, dim)")
        self.batch = int(batch)
        self.n_rows, self.dim = self.data.shape
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(self.n_rows)
        self._cursor = 0
        self.epoch = 0

    def _rows(self, n: int) -> np.ndarray:
        """The next ``n`` rows of the permuted stream, a fresh permutation
        drawn when a row past the epoch's end is asked for."""
        out = np.empty((n, self.dim), dtype=np.float32)
        filled = 0
        while filled < n:
            if self._cursor >= self.n_rows:
                self._cursor = 0
                self.epoch += 1
                self._perm = self._rng.permutation(self.n_rows)
            take = min(n - filled, self.n_rows - self._cursor)
            idx = self._perm[self._cursor:self._cursor + take]
            out[filled:filled + take] = self.data[idx]
            filled += take
            self._cursor += take
        return out

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self._rows(self.batch)

    def next_batches(self, k: int) -> np.ndarray:
        """k batches stacked into (k, batch, dim): a training chunk."""
        return self._rows(k * self.batch).reshape(k, self.batch, self.dim)

    def close(self):
        pass


def make_loader(path_or_array, batch: int, n_rows: int | None = None,
                dim: int | None = None, seed: int = 0) -> NumpyLoader:
    """A `NumpyLoader` over an array, a ``.npy`` file, or a ``.npz`` file
    that holds exactly one array. Raw float32 files (``n_rows``, ``dim``)
    need the native loader, which is not ported yet: they raise."""
    if not isinstance(path_or_array, (str, os.PathLike)):
        return NumpyLoader(path_or_array, batch, seed)
    p = os.fspath(path_or_array)
    if p.endswith(".npy"):
        return NumpyLoader(np.load(p), batch, seed)
    if p.endswith(".npz"):
        with np.load(p) as z:
            if len(z.files) != 1:
                raise ValueError(f"{p} holds {len(z.files)} arrays "
                                 f"{z.files}; make_loader takes one")
            return NumpyLoader(z[z.files[0]], batch, seed)
    raise NotImplementedError(
        f"{p}: raw float32 files need the native prefetching loader, "
        "which is not ported yet; save the data as .npy")
