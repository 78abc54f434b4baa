"""Profiling and step-timing utilities.

Counterpart of `normalizingflows/jl_tpu/utils/profiling.py`: a
`torch.profiler` trace around any block of code, written as a Chrome trace
(the card's kernels with the host's calls when CUDA is available), and a
device-step timer that synchronises by fetching a scalar result to the
host and takes the slope between two step counts, so that fixed set-up,
capture and fetch costs cancel.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

__all__ = ["trace", "time_scan_steps", "sync_fetch"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with `torch.profiler` (host activity, and the
    card's when CUDA is available) and write a Chrome trace into
    ``log_dir`` (``trace_<pid>_<ns>.json``; open it in Perfetto or
    chrome://tracing). Yields the profiler, whose ``key_averages()`` and
    ``events()`` can be read after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def sync_fetch(x) -> float:
    """Force the work behind ``x`` to complete by fetching its first
    element to the host."""
    return float(torch.as_tensor(x).reshape(-1)[0])


def time_scan_steps(run_steps: Callable[[int], torch.Tensor], n: int = 2000,
                    reps: int = 3) -> float:
    """Seconds a step of a device-side loop.

    ``run_steps(m)`` must run m steps and return a tensor (or an array)
    whose value depends on every step (the final loss, say). Each size is
    run once to warm up, then ``reps`` times, each timed up to the fetch
    of that value; the best of ``time(2n)`` less the best of ``time(n)``,
    over n, cancels whatever a call costs besides its steps."""

    def timed(m):
        sync_fetch(run_steps(m))  # build, capture, warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            sync_fetch(run_steps(m))
            best = min(best, time.perf_counter() - t0)
        return best

    t1 = timed(n)
    t2 = timed(2 * n)
    return max((t2 - t1) / n, 1e-12)
