"""The traced part of a `--trace 1` run, read from `torch.profiler`.

The method is `benchmarks/torch_profile.py`'s, frozen here: a profile of
the host and the device over whole steps (or calls) of the window, the
device's busy time as the union of its operations' intervals, and device
time by kernel name. The per-layer readers in `metrics/` take a `Trace`.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    ops: list            # device operations: (name, start_us, end_us)
    host: list           # host events: (name, start_us, end_us)
    window_s: float      # host clock from the profiler's start to its stop
    units: int           # steps or calls in the window
    launches: dict = field(default_factory=dict)  # the port's own counts

    @property
    def kernels(self) -> list:
        return [o for o in self.ops
                if not o[0].startswith(("Memcpy", "Memset"))]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _union(self.ops)) / 1e6

    def seconds(self, match) -> float:
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e6

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.kernels if match(n))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing in them (its innermost event
        at the gap's middle)."""
        by_name: dict = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        gaps: dict = {}
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        spans = _union(self.ops)
        for (_, a), (b, _) in zip(spans[:-1], spans[1:]):
            mid = 0.5 * (a + b)
            name = "(no host event)"
            best = None
            at = bisect.bisect_right(starts, mid)
            for hn, hs, he in host[max(0, at - 32):at]:
                if hs <= mid <= he and (best is None or he - hs < best):
                    name, best = hn, he - hs
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
        order = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], v] for n, v in order],
                "idle_gaps": [[n[:200], v] for n, v in idle]}


def _union(ops) -> list:
    out = []
    for s, e in sorted((o[1], o[2]) for o in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Tracer:
    """`start` and `stop` at boundaries the host has synchronised."""

    def __init__(self, sync):
        self.sync = sync
        self.prof = None
        self.t0 = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.sync()
        self.t0 = time.perf_counter()

    def stop(self, units: int, launches: dict | None = None) -> Trace:
        self.sync()
        window = time.perf_counter() - self.t0
        self.prof.stop()
        from torch.autograd import DeviceType

        ops, host = [], []
        for e in self.prof.events():
            if getattr(e, "is_user_annotation", False) or "#" in e.name:
                continue
            row = (e.name, e.time_range.start, e.time_range.end)
            (ops if e.device_type == DeviceType.CUDA else host).append(row)
        self.prof = None
        return Trace(ops, host, window, units, launches or {})
