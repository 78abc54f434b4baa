"""The port's profiling utilities: the slope timer scales with the work a
step does, `trace` writes a Chrome trace on the CPU, and `sync_fetch`
reads what the JAX package's does."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from normalizingflows.jl_tpu.utils import profiling as jax_profiling  # noqa
from normalizingflows_torch.utils import profiling  # noqa: E402

torch.set_num_threads(1)


def _steps(width):
    def run_steps(n):
        c = torch.eye(width, dtype=torch.float64) * 0.5
        for _ in range(n):
            c = c @ c / torch.clamp(c.abs().max(), min=1.0)
        return c

    return run_steps


def test_time_scan_steps_scales_with_work():
    small = profiling.time_scan_steps(_steps(32), n=40, reps=2)
    big = profiling.time_scan_steps(_steps(256), n=40, reps=2)
    assert 0 < small < big


def test_time_scan_steps_fetches_the_result(monkeypatch):
    """Each call is timed up to the fetch of its returned value (one warm
    call and ``reps`` timed ones a size), between n and 2n steps."""
    calls, fetched = [], []
    monkeypatch.setattr(profiling, "sync_fetch",
                        lambda x: fetched.append(int(x)) or float(x))

    def run_steps(n):
        calls.append(n)
        return torch.tensor(float(n))

    assert profiling.time_scan_steps(run_steps, n=5, reps=3) > 0
    assert calls == [5] * 4 + [10] * 4 and fetched == calls


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with profiling.trace(str(d)) as prof:
        torch.ones(128, 128).sum().item()
    files = [f for f in d.rglob("*") if f.is_file()]
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::sum" in str(e.get("name")) for e in events)
    assert any(e.key == "aten::sum" for e in prof.key_averages())


def test_sync_fetch_reads_the_first_element():
    x = np.full((3, 3), 7.0)
    x[0, 0] = 2.5
    assert profiling.sync_fetch(torch.from_numpy(x)) == \
        jax_profiling.sync_fetch(x) == 2.5
    assert profiling.sync_fetch(x) == 2.5
    assert profiling.sync_fetch(torch.tensor(4.0)) == 4.0
