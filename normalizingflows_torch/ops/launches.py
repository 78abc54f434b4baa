"""Launch counts of the hand-written kernels K1–K6, and graphs that count
their replays.

Each kernel's wrapper calls `count` where it launches its kernel, and
nowhere else: K1 ``rqs_fwd``, K2 ``rqs_bwd_fwddir`` and K3
``rqs_bwd_invdir`` (`ops/rqs_cuda.py`), K4 ``coupling_fwd`` and K5
``coupling_bwd`` (`experimental/coupling_cuda.py`), K6 ``realnvp_train``
(`experimental/train_cuda.py`), each in float32 or float64. The bfloat16
instantiations count apart, under their C entries' names: K1–K3 with
``_f32_rbf16`` (bfloat16 raw beside a float32 x) or ``_bf16`` (bfloat16
x and raw), K4/K5 with ``_f32_cbf16`` (the bf16 compute_dtype policy) or
``_bf16`` (bfloat16 parameters), K6 with ``_bf16`` (bfloat16 parameters).

A CUDA graph runs the kernels captured in it at each replay, and none at
capture, while the wrappers' Python runs only at capture. `CountedGraph`
therefore takes back the counts its capture added and adds them again at
every replay: after a run, eager or graphed, `counts` is what the device
launched.
"""

from __future__ import annotations

import contextlib

__all__ = ["KERNELS", "BF16_KERNELS", "count", "counts", "reset",
           "captures", "CountedGraph", "name_of"]

_BASE = ("rqs_fwd", "rqs_bwd_fwddir", "rqs_bwd_invdir", "coupling_fwd",
         "coupling_bwd", "realnvp_train")
BF16_KERNELS = tuple(
    [f"{k}_{s}" for k in _BASE[:3] for s in ("f32_rbf16", "bf16")]
    + [f"{k}_{s}" for k in _BASE[3:5] for s in ("f32_cbf16", "bf16")]
    + ["realnvp_train_bf16"])
KERNELS = _BASE + BF16_KERNELS

# launches since import (or since the last `reset`), and graphs captured
_COUNTS = dict.fromkeys(KERNELS, 0)
_CAPTURES = 0


def name_of(kernel: str, suffix: str) -> str:
    """The count of ``kernel``'s instantiation with the C entry suffix
    ``suffix``: the kernel's own for "f32" and "f64", else its own."""
    return kernel if suffix in ("f32", "f64") else f"{kernel}_{suffix}"


def count(name: str) -> None:
    """One launch of kernel ``name``."""
    if name not in _COUNTS:
        raise KeyError(f"no kernel {name!r}; the kernels are {KERNELS}")
    _COUNTS[name] += 1


def counts() -> dict:
    """Launches of every kernel since the last `reset`."""
    return dict(_COUNTS)


def captures() -> int:
    """`CountedGraph` captures since the last `reset`."""
    return _CAPTURES


def reset() -> None:
    """Every count, and the captures, to 0."""
    global _CAPTURES
    for name in _COUNTS:
        _COUNTS[name] = 0
    _CAPTURES = 0


class CountedGraph:
    """A graph (a `torch.cuda.CUDAGraph`, or any object with ``replay()``)
    whose replays count the kernel launches its capture recorded."""

    def __init__(self, graph):
        self.graph = graph
        self.per_replay = dict.fromkeys(KERNELS, 0)

    @contextlib.contextmanager
    def capture(self, context):
        """Run the block inside ``context`` (``torch.cuda.graph(self.graph,
        ...)``), which records its launches and executes none: the counts
        the block adds become the graph's per replay and are taken back,
        whether or not the capture succeeds."""
        global _CAPTURES
        before = counts()
        try:
            with context:
                yield self
        finally:
            self.per_replay = {k: _COUNTS[k] - before[k] for k in KERNELS}
            for k, n in self.per_replay.items():
                _COUNTS[k] -= n
        _CAPTURES += 1

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.per_replay.items():
            _COUNTS[k] += n
