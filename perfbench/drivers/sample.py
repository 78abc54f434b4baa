"""Drawing from a flow: one closed-loop caller of the port's
`sample_and_log_prob` under `torch.no_grad`, each call ``batch`` samples
with their log-density, the next call made once the last one's result is
ready on the device, as a Monte-Carlo or importance-sampling loop makes
them.

Traffic parameters: ``batch`` (samples a call), ``warm_calls`` (set-up
calls before the window), ``kept_calls`` (calls whose results are judged:
a uniform sample of the window's calls, drawn from the seed).

`correct`: for each kept call the float64 reference transforms the same
base draws (made again from the generator's state before the call); the
worst element's gap of the samples and of their log-densities is
compared (`checks.row_gap`).
"""

from __future__ import annotations

import math
import random
import time

import torch

from .. import checks, systems, weights
from ..harness import TRACE_S, Outcome, Stopwatch
from ..reference import vi
from ..tracing import Tracer

REF_ROWS = 16384  # the reference's block of rows


def _program(run):
    cfg, traffic = run.cell.config, run.cell.traffic
    nft, fam = systems.program(), systems.family(cfg)
    ref, _ = vi.modules(cfg)
    batch, n_kept = traffic["batch"], traffic["kept_calls"]
    gen = weights.generator(run.seed, run.device)
    w = weights.draw(ref.leaves(cfg), gen, run.device)
    run.mark("the port imported")
    flow = fam.build(cfg, w, run.device)
    del w
    run.mark("the flow built")
    with torch.no_grad():
        for _ in range(traffic["warm_calls"]):
            flow.sample_and_log_prob(gen, (batch,))
    run.sync()

    pick = random.Random(run.seed)
    kept, lat = [], []
    watch = Stopwatch(run.device)
    launches = nft.ops.launches
    tracer = Tracer(run.sync) if run.trace else None
    trace = None
    if tracer is not None:
        counts0 = launches.counts()
        tracer.start()
    start = time.perf_counter()
    run.mark("the window opens")
    calls = 0
    while True:
        slot = calls if calls < n_kept else pick.randrange(calls + 1)
        state = gen.get_state() if slot < n_kept else None
        watch.start()
        with torch.no_grad():
            y, lq = flow.sample_and_log_prob(gen, (batch,))
        lat.append(watch.stop())
        if state is not None:
            entry = (state, y, lq)
            if slot < len(kept):
                kept[slot] = entry
            else:
                kept.append(entry)
        del y, lq
        calls += 1
        now = time.perf_counter()
        done = now - start >= run.seconds
        if tracer is not None and tracer.prof is not None and (
                now - tracer.t0 >= TRACE_S or done):
            counts = {k: v - counts0[k] for k, v in launches.counts().items()
                      if v != counts0[k]}
            trace = tracer.stop(calls, counts)
        if done:
            break
    run.sync()
    window = time.perf_counter() - start
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    srt = sorted(lat)
    metrics = {"samples_per_s": calls * batch / window,
               "sample_p95_ms": srt[math.ceil(0.95 * len(srt)) - 1],
               "setup_s": start - run.t_process}
    run.log(f"window: {calls} calls in {window!r} s; latency median "
            f"{srt[(len(srt) - 1) // 2]!r} ms, p95 "
            f"{metrics['sample_p95_ms']!r} ms over {len(srt)} calls; "
            f"set-up {metrics['setup_s']!r} s")
    return metrics, calls, peak, trace, kept


def reference_of(run, state, precision="float64"):
    """(y, log q) of the reference at the call's base draws, in blocks of
    REF_ROWS rows."""
    cfg, batch = run.cell.config, run.cell.traffic["batch"]
    ref, _ = vi.modules(cfg)
    gen = weights.generator(run.seed, run.device)
    w = vi.cast(weights.draw(ref.leaves(cfg), gen, run.device), precision)
    gen.set_state(state)
    x = torch.randn((batch, cfg["dim"]), generator=gen, device=run.device)
    ys, lqs = [], []
    with torch.no_grad():
        for at in range(0, batch, REF_ROWS):
            xb = x[at:at + REF_ROWS].to(w[next(iter(w))].dtype)
            y, lq = vi.sample_and_log_prob(w, xb, cfg, precision)
            ys.append(y)
            lqs.append(lq)
    return torch.cat(ys), torch.cat(lqs)


def readings(program: list, reference: list, states: list) -> dict:
    """Worst gaps over the kept calls ([(y, log q)] of each side), and
    whether two kept calls drew from the same generator state: each call
    has to draw anew, else a stale answer would pass."""
    distinct = {bytes(st.cpu().numpy()) for st in states}
    return {"samples": max(checks.row_gap(p[0], r[0])
                           for p, r in zip(program, reference)),
            "log_density": max(checks.row_gap(p[1], r[1])
                               for p, r in zip(program, reference)),
            "repeated_draws": float(len(states) - len(distinct))}


def run(run) -> Outcome:
    metrics, calls, peak, trace, kept = _program(run)

    def judge():
        return readings([(y, lq) for _, y, lq in kept],
                        [reference_of(run, st) for st, _, _ in kept],
                        [st for st, _, _ in kept])

    return Outcome(metrics, calls, peak, trace, judge)
