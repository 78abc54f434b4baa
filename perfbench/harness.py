"""One run of one cell: the traffic mix's driver runs the program, its
judge holds what the window produced against the plain reference, and the
run's result line is assembled here.

A driver (`drivers/<kind>.py`, the traffic's ``kind``) has
``run(Run) -> Outcome``. It builds the program from the seed, warms up
the cell's own shapes, runs the window and returns with every object of
the program released; `Outcome.judge` then runs the reference.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from . import checks, guard, peaks, spec, work
from .spec import HERE, Cell

# seconds of the window a `--trace 1` run profiles, in whole steps or calls
TRACE_S = 1.0


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float                     # perf_counter at process start
    log: Callable = field(default=lambda *a: print(*a, file=sys.stderr,
                                                   flush=True))

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, what: str):
        """Log how far into the process ``what`` came."""
        self.log(f"{time.perf_counter() - self.t_process:9.3f} s: {what}")


@dataclass
class Outcome:
    metrics: dict          # end-to-end metric name -> value
    attempted: int         # steps or calls in the window
    memory_peak: int
    trace: object          # tracing.Trace of a --trace 1 run, else None
    judge: Callable        # () -> {number name: reading}


class Stopwatch:
    """One call's latency in ms: CUDA events on the card (the device's
    clock, from the call's first work queued to its last done), the host
    clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t) * 1e3


@dataclass
class Context:
    """What a per-layer reader reads."""
    cell: Cell
    trace: object
    work: object = work
    peaks: object = peaks


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError) as err:
        return f"not read ({err})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "not read"


def build_kernels(log) -> float:
    """Load the port's kernel library, built by nvcc only in a checkout's
    first run: nvcc's seconds, 0.0 where the library was there."""
    from normalizingflows_torch.ops import _build

    t = time.perf_counter()
    built = _build.build()
    _build.library()
    what = (f"built by nvcc in {built.seconds!r} s" if built.seconds
            else "found built")
    log(f"kernel library: {what} ({time.perf_counter() - t!r} s with "
        "loading); setup_s holds it")
    return built.seconds


def run_cell(run: Run) -> tuple[dict, list]:
    """(the result line, [(number, reading, limit)])."""
    cell = run.cell
    driver = importlib.import_module(
        f"{__package__}.drivers.{cell.traffic['kind']}")
    out = driver.run(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    rows = checks.verdict(out.judge(), cell.limits)
    correct = checks.passed(rows)

    if run.trace:
        ctx = Context(cell, out.trace)
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(ctx) if out.trace is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.metrics[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out.metrics}

    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(out.memory_peak)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": sum(1 for _, v, lim in rows if not v <= lim),
              "metrics": metrics, "device": device}
    if run.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
        run.log("launches of K1-K6 in the traced window (ops/launches.py): "
                + json.dumps(out.trace.launches))
    if run.device.type == "cuda":
        device["power_limit"] = power_limit()
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def finish(result: dict, rows: list, log) -> int:
    """The guard, then the numbers compared as the last lines of standard
    error and the result as the last line of standard output."""
    found = guard.forbidden()
    if found:
        log(f"refusing to report: modules {found} are loaded; the run "
            "measures the port alone")
        return 3
    for k, v, lim in rows:
        log(f"check {k} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None, t_process: float | None = None) -> int:
    import argparse

    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} here")
        return 2
    run = Run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda"), t_process, log)
    build_s = build_kernels(log)
    result, rows = run_cell(run)
    checks_ = result.pop("checks")
    result["build_s"] = build_s
    result["checks"] = checks_
    return finish(result, rows, log)
