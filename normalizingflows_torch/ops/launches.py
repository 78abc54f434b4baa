"""Launch counts of the hand-written kernels K1–K6, and graphs that count
their replays.

Each kernel's wrapper calls `count` where it launches its kernel, and
nowhere else: K1 ``rqs_fwd``, K2 ``rqs_bwd_fwddir`` and K3
``rqs_bwd_invdir`` (`ops/rqs_cuda.py`), K4 ``coupling_fwd`` and K5
``coupling_bwd`` (`experimental/coupling_cuda.py`), K6 ``realnvp_train``
(`experimental/train_cuda.py`).

A CUDA graph runs the kernels captured in it at each replay, and none at
capture, while the wrappers' Python runs only at capture. `CountedGraph`
therefore takes back the counts its capture added and adds them again at
every replay: after a run, eager or graphed, `counts` is what the device
launched.
"""

from __future__ import annotations

import contextlib

__all__ = ["KERNELS", "count", "counts", "reset", "captures",
           "CountedGraph"]

KERNELS = ("rqs_fwd", "rqs_bwd_fwddir", "rqs_bwd_invdir", "coupling_fwd",
           "coupling_bwd", "realnvp_train")

# launches since import (or since the last `reset`), and graphs captured
_COUNTS = dict.fromkeys(KERNELS, 0)
_CAPTURES = 0


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
