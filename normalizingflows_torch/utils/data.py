"""Data loading for forward-KL (maximum-likelihood) training.

Counterpart of `normalizingflows/jl_tpu/utils/data.py`:

  * `NativeLoader`: a ctypes binding to the C++ prefetching loader
    (`native/dataloader.cc`, the same source the JAX package binds): an
    mmapped raw float32 (n_rows, dim) file, shuffled per epoch by one
    producer thread (xoshiro256** Fisher–Yates), batches filled into a ring
    of prefetch buffers. From one seed it yields the JAX package's
    `NativeLoader` batches exactly. The library is built at first use with
    ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` (the JAX package's flags)
    into ``build/torch_native/``, under a name that carries a hash of the
    source and the flags. A failed build raises: there is no numpy
    fallback.
  * `NumpyLoader`: shuffled minibatches of an in-memory array; from one
    seed it yields the JAX package's `NumpyLoader` batches exactly.
  * `make_loader`: arrays and ``.npy``/``.npz`` files through
    `NumpyLoader`, raw float32 files through `NativeLoader`.
  * `to_raw_file`: write an array in the native loader's format.

Both loaders' ``next_batches(k, out=)`` write k batches straight into a
caller's (k, batch, dim) float32 buffer (a numpy array or a CPU tensor,
page-locked or not): `train_flow_mle` keeps one page-locked buffer and
copies it to the card without blocking.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

__all__ = ["NativeLoader", "NumpyLoader", "to_raw_file", "make_loader"]

ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = ROOT / "native" / "dataloader.cc"
BUILD_DIR = ROOT / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def build_native(cxx: str = CXX, build_dir: Path = BUILD_DIR) -> Path:
    """Compile `native/dataloader.cc` with ``cxx`` into ``build_dir``
    unless a library of this exact source and these flags is there;
    returns its path. A failed compile raises RuntimeError."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(NATIVE_SRC.read_bytes())
    out = Path(build_dir) / f"libnf_dataloader_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, str(NATIVE_SRC), "-o", str(tmp)],
            capture_output=True, text=True, check=False)
    except OSError as err:
        raise RuntimeError(f"building the native data loader with {cxx!r} "
                           f"failed: {err}") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native data loader with {cxx!r} "
                           f"failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process never loads a partial .so
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    """The loader's library, built on first call, its entries typed."""
    lib = ctypes.CDLL(str(build_native()))
    i64, ptr = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    lib.dl_open.restype = i64
    lib.dl_open.argtypes = [ctypes.c_char_p, i64, i64, i64, ctypes.c_uint64,
                            i64]
    lib.dl_next.restype = ptr
    lib.dl_next.argtypes = [i64]
    lib.dl_release.restype = None
    lib.dl_release.argtypes = [i64, ptr]
    lib.dl_close.restype = None
    lib.dl_close.argtypes = [i64]
    return lib


def to_raw_file(path: str, data) -> str:
    """Write (n, dim) float32 row-major raw file (the native loader's
    format)."""
    arr = np.ascontiguousarray(np.asarray(data, dtype=np.float32))
    if arr.ndim != 2:
        raise ValueError("data must be (n_rows, dim)")
    arr.tofile(path)
    return path


def _raw_rows(path, dim: int) -> int:
    """The rows of a raw float32 file of ``dim`` columns, from its size."""
    size = os.path.getsize(path)
    if size % (4 * dim):
        raise ValueError(f"{path}: {size} bytes is not a whole number of "
                         f"float32 rows of {dim}")
    return size // (4 * dim)


def _batches_out(out, k: int, batch: int, dim: int) -> np.ndarray:
    """``out`` (None, a numpy array or a CPU tensor of (≥ k, batch, dim)
    float32) as the numpy array the k batches are written into."""
    if out is None:
        return np.empty((k, batch, dim), dtype=np.float32)
    arr = out.numpy() if isinstance(out, torch.Tensor) else out
    if (arr.dtype != np.float32 or arr.shape[1:] != (batch, dim)
            or arr.shape[0] < k or not arr.flags.c_contiguous):
        raise ValueError(f"out must be a contiguous float32 buffer of "
                         f"({k}, {batch}, {dim}), got {arr.dtype} "
                         f"{arr.shape}")
    return arr[:k]


class NativeLoader:
    """Shuffled minibatches of an mmapped raw float32 (n_rows, dim) file,
    prefetched by a C++ producer thread (the JAX package's
    `NativeLoader`, on the same library source). `epoch` counts the
    epochs that the rows handed out so far have completed, as
    `NumpyLoader` does, not how far the producer has run ahead."""

    def __init__(self, path: str, n_rows: int, dim: int, batch: int,
                 seed: int = 0, n_prefetch: int = 4):
        self._lib = _library()
        self.n_rows, self.dim, self.batch = int(n_rows), int(dim), int(batch)
        self._handle = self._lib.dl_open(
            os.fspath(path).encode(), self.n_rows, self.dim, self.batch,
            seed, n_prefetch)
        if self._handle < 0:
            raise IOError(f"cannot open dataset {path!r} "
                          f"({n_rows}x{dim} float32)")
        self._taken = 0  # batches handed out

    def _take(self, dst: np.ndarray):
        """Copy the next ready batch into ``dst`` (batch, dim) and hand its
        buffer back to the prefetch ring."""
        ptr = self._lib.dl_next(self._handle)
        np.copyto(dst, np.ctypeslib.as_array(ptr, shape=(self.batch,
                                                         self.dim)))
        self._lib.dl_release(self._handle, ptr)
        self._taken += 1

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        """The next (batch, dim) array, a copy safe to hold."""
        out = np.empty((self.batch, self.dim), dtype=np.float32)
        self._take(out)
        return out

    def next_batches(self, k: int, out=None) -> np.ndarray:
        """k batches as (k, batch, dim), written into ``out`` if given."""
        arr = _batches_out(out, k, self.batch, self.dim)
        for i in range(k):
            self._take(arr[i])
        return arr

    @property
    def epoch(self) -> int:
        """Epochs completed by the rows handed out: what the producer's
        count was when it had filled exactly those batches (an epoch ends
        when a row past its end is asked for)."""
        return max(self._taken * self.batch - 1, 0) // self.n_rows

    def close(self):
        if self._handle >= 0:
            self._lib.dl_close(self._handle)
            self._handle = -1

    def __del__(self):
        if getattr(self, "_handle", -1) >= 0:
            self.close()


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

    def _rows(self, out: np.ndarray) -> np.ndarray:
        """Fill ``out`` (n, dim) with the next n rows of the permuted
        stream, a fresh permutation drawn when a row past the epoch's end
        is asked for."""
        filled = 0
        while filled < len(out):
            if self._cursor >= self.n_rows:
                self._cursor = 0
                self.epoch += 1
                self._perm = self._rng.permutation(self.n_rows)
            take = min(len(out) - filled, self.n_rows - self._cursor)
            idx = self._perm[self._cursor:self._cursor + take]
            np.take(self.data, idx, axis=0, out=out[filled:filled + take])
            filled += take
            self._cursor += take
        return out

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self._rows(np.empty((self.batch, self.dim), dtype=np.float32))

    def next_batches(self, k: int, out=None) -> np.ndarray:
        """k batches as (k, batch, dim), written into ``out`` if given: a
        training chunk."""
        arr = _batches_out(out, k, self.batch, self.dim)
        self._rows(arr.reshape(k * self.batch, self.dim))
        return arr

    def close(self):
        pass


def make_loader(path_or_array, batch: int, n_rows: int | None = None,
                dim: int | None = None, seed: int = 0):
    """A `NumpyLoader` over an array, a ``.npy`` file, or a ``.npz`` file
    that holds exactly one array; a `NativeLoader` over any other path, a
    raw float32 file of ``n_rows`` rows of ``dim`` (``n_rows`` defaults to
    what the file's size holds)."""
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
    if dim is None:
        raise ValueError("dim is required for a raw float32 file")
    if n_rows is None:
        n_rows = _raw_rows(p, dim)
    return NativeLoader(p, n_rows, dim, batch, seed)
