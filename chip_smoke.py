#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the hand-written CUDA kernels from ``normalizingflows_torch/csrc``
and drives the port's main path, reverse-KL ELBO training of the neural
spline flow, through them:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc of csrc/*.cu, its seconds and ptxas register/spill report;
3. kernels against their plain torch versions on the card: K1 forward and
   inverse, K2's gx/graw, at N = 64 (demo), 1000 (ragged) and 131072 (wide),
   K 8 and 10, float32 and float64, raw read elem-major and param-major;
   median device times of kernel and plain version at N = 64 and 131072;
4. one `elbo_from_samples` value-and-grad on the demo model with
   backend="cuda" and backend="plain" from identical parameters and draws;
5. the main path: `train_flow` on the demo slice (nsf on Banana(2, 1, 100),
   64 samples, Adam(5e-4)) for 300 steps, with launch counts;
6. the wide configuration (d=64, hdims (128, 128), K=10, 10 layers, batch
   4096, float32) for 20 steps: steps/s and peak memory;
7. round trip: `log_prob(y)` through the inverse (K1) against
   `sample_and_log_prob`'s value on the trained demo flow.

Any failure raises, so the exit code is not 0. Without a CUDA device, or
outside a checkout of the repository, it fails before printing a result.
The last line of standard output is the device JSON; the line before it the
per-kernel JSON.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import torch

DEVICE = "cuda"
B = 30.0              # the NSF box half-width (nsf default)
SIZES = (64, 1000, 131072)
DEMO = dict(q0=2, hdims=(32, 32), K=10, B=B, nlayers=10, identity_init=True)
WIDE = dict(q0=64, hdims=(128, 128), K=10, B=B, nlayers=10,
            identity_init=True)
DEMO_STEPS, DEMO_BATCH, DEMO_LR = 300, 64, 5e-4
WIDE_STEPS, WIDE_BATCH, WIDE_LR = 20, 4096, 1e-3
# Kernel against plain version. f32: tests/test_rqs_kernel.py:43-44 (values
# rtol/atol 1e-5; log-dets rtol 1e-4, atol 1e-5) and :78-79 (gradients rtol
# 2e-3, atol 1e-4). f64: rtol 1e-9, atol 1e-10, the same differences at f64
# precision. Built without contraction, the kernel rounds as the plain
# version does; these bound what exp/log implementations may still move.
TOL = {
    torch.float32: dict(y=(1e-5, 1e-5), ld=(1e-4, 1e-5), g=(2e-3, 1e-4)),
    torch.float64: dict(y=(1e-9, 1e-10), ld=(1e-9, 1e-10), g=(1e-9, 1e-10)),
}
# Same train step on the two backends (float32): the gradient tolerance
# above, over 20 couplings whose differences add up.
STEP_TOL = (2e-3, 1e-4)
# Round trip log_prob(y) vs sample_and_log_prob (float32, log-densities of
# order 1-10 nats through 20 couplings each way, the inverse amplifying
# roundings where a spline's slope nears its 1e-3 floor; a CPU run of the
# plain path reached 1e-3): rtol 1e-3, atol 1e-2.
ROUND_TRIP_TOL = (1e-3, 1e-2)


def say(phase: int, msg: str):
    print(f"[phase {phase}] {msg}", flush=True)


def compare(name, got, want, tol, quiet=False) -> float:
    """Max abs error; raises if any element is outside rtol/atol."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    bound = tol[1] + tol[0] * want.abs()
    bad = int((err > bound).sum())
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    max_abs = float(err.max()) if err.numel() else 0.0
    rel = err / want.abs().clamp_min(1e-30)
    max_rel = float(rel.max()) if rel.numel() else 0.0
    if not quiet or bad or not finite:
        print(f"    {name}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
              f"outside tol {bad}/{err.numel()}", flush=True)
    if bad or not finite:
        raise AssertionError(f"{name}: {bad} elements outside rtol "
                             f"{tol[0]} atol {tol[1]} (finite={finite})")
    return max_abs


def device_ms(fn, reps=7, inner=20) -> float:
    """Median over ``reps`` of the device time of one call of ``fn``.
    After a warmup, ``inner`` calls are captured once into a CUDA graph,
    which is replayed between two CUDA events: the time is the card's, not
    the host's launch cost (tens of µs a call, more than the kernel)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # capture wants the warmup off-stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    say(1, f"{name}, {torch.cuda.device_count()} device(s), torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build():
    from normalizingflows_torch.ops import _build

    build = _build.build()
    say(2, f"nvcc {build.seconds:.1f} s -> {build.path.name}")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("    " + line.strip(), flush=True)
    _build.library()


def phase_kernels(gen):
    """K1 (forward, inverse) and K2 against the plain tiles on the card."""
    from normalizingflows_torch.ops import rqs_cuda

    results = {"rqs_fwd": {"err": 0.0}, "rqs_bwd_fwddir": {"err": 0.0}}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        for K in (8, 10):
            P = 3 * K - 1
            for n in SIZES:
                # the main path's layout: x (batch, n_t), raw a view of the
                # conditioner's (batch, n_t·(3K−1)) output
                n_t = 32 if n == 131072 else 1
                batch = n // n_t
                x = (torch.rand((batch, n_t), generator=gen, device=DEVICE,
                                dtype=dtype) * 3.0 - 1.5) * B
                raw = 3.0 * torch.randn((batch, n_t * P), generator=gen,
                                        device=DEVICE, dtype=dtype)
                raw3 = raw.view(batch, n_t, P)
                xf, rawf = x.reshape(-1), raw.view(-1, P)
                tag = f"{str(dtype)[6:]} K={K} N={n}"
                for inverse in (False, True):
                    y, ld = rqs_cuda.rqs_fused(x, raw3, B, inverse=inverse,
                                               backend="cuda")
                    y_p, ld_p = rqs_cuda.tile_transform(xf, rawf, B, inverse)
                    d = "inv" if inverse else "fwd"
                    e = max(compare(f"K1 {d} y  {tag}", y.reshape(-1), y_p,
                                    tol["y"]),
                            compare(f"K1 {d} ld {tag}", ld.reshape(-1), ld_p,
                                    tol["ld"]))
                    if dtype == torch.float32 and K == 10 and n != 1000:
                        results["rqs_fwd"]["err"] = max(
                            results["rqs_fwd"]["err"], e)
                    # param-major read of the same numbers: identical
                    y_t, ld_t = rqs_cuda.rqs_fused(
                        xf, rawf.T.contiguous().T, B, inverse=inverse,
                        backend="cuda")
                    if not (torch.equal(y_t, y.reshape(-1))
                            and torch.equal(ld_t, ld.reshape(-1))):
                        raise AssertionError(f"K1 {d} {tag}: param-major "
                                             "read differs from elem-major")
                xg = x.clone().requires_grad_()
                rg = raw3.clone().requires_grad_()
                y, ld = rqs_cuda.rqs_fused(xg, rg, B, backend="cuda")
                gy = torch.randn(y.shape, generator=gen, device=DEVICE,
                                 dtype=dtype)
                gld = torch.randn(y.shape, generator=gen, device=DEVICE,
                                  dtype=dtype)
                gx, graw = torch.autograd.grad((y, ld), (xg, rg), (gy, gld))
                gx_p, graw_p = rqs_cuda.tile_bwd_analytic(
                    xf, rawf, gy.reshape(-1), gld.reshape(-1), B)
                e = max(compare(f"K2 gx   {tag}", gx.reshape(-1), gx_p,
                                tol["g"]),
                        compare(f"K2 graw {tag}", graw.reshape(-1, P),
                                graw_p, tol["g"]))
                if dtype == torch.float32 and K == 10 and n != 1000:
                    results["rqs_bwd_fwddir"]["err"] = max(
                        results["rqs_bwd_fwddir"]["err"], e)
    torch.cuda.synchronize()

    # times at the demo and wide shapes, float32, K=10
    for n in (64, 131072):
        n_t = 32 if n == 131072 else 1
        batch, P = n // n_t, 29
        x = (torch.rand((n,), generator=gen, device=DEVICE) * 3 - 1.5) * B
        raw = 3.0 * torch.randn((batch, n_t * P), generator=gen,
                                device=DEVICE).view(n, P)
        gy = torch.randn((n,), generator=gen, device=DEVICE)
        gld = torch.randn((n,), generator=gen, device=DEVICE)
        t = {
            "rqs_fwd": (
                device_ms(lambda: rqs_cuda._launch_fwd(x, raw, B, False)),
                device_ms(lambda: rqs_cuda.tile_transform(x, raw, B))),
            "rqs_fwd inverse": (
                device_ms(lambda: rqs_cuda._launch_fwd(x, raw, B, True)),
                device_ms(lambda: rqs_cuda.tile_transform(x, raw, B, True))),
            "rqs_bwd_fwddir": (
                device_ms(lambda: rqs_cuda._launch_bwd(x, raw, gy, gld, B)),
                device_ms(lambda: rqs_cuda.tile_bwd_analytic(
                    x, raw, gy, gld, B))),
        }
        for name, (ms, plain_ms) in t.items():
            if name in results:
                key = "" if n == 131072 else "_demo"
                results[name]["ms" + key] = ms
                results[name]["plain_ms" + key] = plain_ms
            say(3, f"{name} N={n} f32 K=10: kernel {ms:.5f} ms, plain "
                   f"{plain_ms:.5f} ms (device time a call: median of 7 "
                   f"CUDA-graph replays of 20 calls, CUDA events)")
    return results


def _demo_flow(backend="auto", seed=0):
    import normalizingflows_torch as nft

    return nft.nsf(torch.Generator().manual_seed(seed), device=DEVICE,
                   backend=backend, **DEMO)


def phase_same_step(gen):
    """One ELBO value-and-grad, kernels against plain, same everything."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import rqs_cuda

    flow_c = _demo_flow("cuda", seed=1)
    with torch.no_grad():  # off the identity: noise 0.1 on every parameter
        noise = torch.Generator(device=DEVICE).manual_seed(2)
        for p in flow_c.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=noise, device=DEVICE))
    flow_p = copy.deepcopy(flow_c)
    flow_p.bijector.bijectors[0].backend = "plain"
    target = nft.Banana(2, 1.0, 100.0)
    xs = flow_c.base.sample(gen, (DEMO_BATCH,)).detach()
    out = {}
    per_step = 2 * DEMO["nlayers"]
    for label, flow in (("cuda", flow_c), ("plain", flow_p)):
        counts = (rqs_cuda.FWD_LAUNCHES, rqs_cuda.BWD_LAUNCHES)
        loss = -nft.elbo_from_samples(xs, flow, target.log_prob)
        loss.backward()
        torch.cuda.synchronize()
        launched = (rqs_cuda.FWD_LAUNCHES - counts[0],
                    rqs_cuda.BWD_LAUNCHES - counts[1])
        want = (per_step, per_step) if label == "cuda" else (0, 0)
        if launched != want:
            raise AssertionError(f"{label} backend launched (K1, K2) "
                                 f"{launched} times, expected {want}")
        out[label] = (loss.detach(), {n: p.grad for n, p in
                                      flow.named_parameters()
                                      if p.grad is not None})
    compare("loss", out["cuda"][0].reshape(1), out["plain"][0].reshape(1),
            STEP_TOL)
    grads_c, grads_p = out["cuda"][1], out["plain"][1]
    if set(grads_c) != set(grads_p) or len(grads_c) != 10 * 2 * 3 * 2 + 2:
        raise AssertionError("the two backends differ in which parameters "
                             "got gradients")
    worst = max(compare(f"grad {n}", grads_c[n], grads_p[n], STEP_TOL,
                        quiet=True) for n in sorted(grads_c))
    say(4, f"loss {float(out['cuda'][0]):.6f} on both backends; "
           f"{len(grads_c)} gradients agree (max abs err {worst:.3e}); the "
           f"cuda pass launched K1 and K2 {per_step} times each, the plain "
           f"pass neither")


def phase_main_path(gen, name):
    """train_flow on the demo slice: the port's main path."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import rqs_cuda

    flow = _demo_flow()
    target = nft.Banana(2, 1.0, 100.0)
    stamps = []

    def callback(it, stat, f):
        stamps.append((it, time.perf_counter()))  # after the chunk's fetch

    torch.cuda.synchronize()
    rqs_cuda.FWD_LAUNCHES = rqs_cuda.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    res = nft.train_flow(
        gen, nft.elbo_batch, flow, target.log_prob, DEMO_BATCH,
        max_iters=DEMO_STEPS, check_every=100, callback=callback,
        optimizer=lambda p: torch.optim.Adam(p, lr=DEMO_LR))
    t1 = time.perf_counter()
    launches = {"rqs_fwd": rqs_cuda.FWD_LAUNCHES,
                "rqs_bwd_fwddir": rqs_cuda.BWD_LAUNCHES}

    losses = res.stats["loss"]
    if len(losses) != DEMO_STEPS or not torch.isfinite(
            torch.from_numpy(losses)).all():
        raise AssertionError("demo training gave non-finite losses")
    first, last = losses[:20].mean(), losses[-20:].mean()
    if not last < first:
        raise AssertionError(f"demo loss did not fall: {first} -> {last}")
    per_step = 2 * DEMO["nlayers"]
    for k, v in launches.items():
        if v != per_step * DEMO_STEPS:
            raise AssertionError(f"{k}: {v} launches in {DEMO_STEPS} steps, "
                                 f"expected {per_step} per step")
    steady = (stamps[-1][0] - stamps[0][0]) / (stamps[-1][1] - stamps[0][1])
    say(5, f"ELBO {-losses[0]:.4f} -> {-losses[-1]:.4f} (mean of first 20 "
           f"{-first:.4f}, last 20 {-last:.4f}); {DEMO_STEPS} steps in "
           f"{t1 - t0:.2f} s = {DEMO_STEPS / (t1 - t0):.1f} steps/s overall, "
           f"{steady:.1f} steps/s after the first chunk, on {name}")
    say(5, f"launches: rqs_fwd {launches['rqs_fwd']}, rqs_bwd_fwddir "
           f"{launches['rqs_bwd_fwddir']} ({per_step} each per step)")
    return flow, launches


def phase_wide(gen, name):
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import rqs_cuda

    flow = nft.nsf(torch.Generator().manual_seed(3), device=DEVICE, **WIDE)
    target = nft.Banana(64, 1.0, 100.0)
    kw = dict(optimizer=lambda p: torch.optim.Adam(p, lr=WIDE_LR))
    warm = nft.train_flow(gen, nft.elbo_batch, flow, target.log_prob,
                          WIDE_BATCH, max_iters=2, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd0, bwd0 = rqs_cuda.FWD_LAUNCHES, rqs_cuda.BWD_LAUNCHES
    t0 = time.perf_counter()
    res = nft.train_flow(gen, nft.elbo_batch, flow, target.log_prob,
                         WIDE_BATCH, max_iters=WIDE_STEPS,
                         check_every=WIDE_STEPS, resume_state=warm.state, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = res.stats["loss"]
    if not torch.isfinite(torch.from_numpy(losses)).all():
        raise AssertionError("wide training gave non-finite losses")
    if (rqs_cuda.FWD_LAUNCHES - fwd0, rqs_cuda.BWD_LAUNCHES - bwd0) != (
            20 * WIDE_STEPS, 20 * WIDE_STEPS):
        raise AssertionError("wide training did not launch K1 and K2 20x "
                             "each per step")
    say(6, f"wide f32 d=64 [128,128]x10 K=10 batch {WIDE_BATCH}: "
           f"{WIDE_STEPS} steps in {dt:.3f} s = {WIDE_STEPS / dt:.2f} steps/s"
           f", peak memory {peak / 2**20:.1f} MiB, loss {losses[0]:.2f} -> "
           f"{losses[-1]:.2f}, on {name}")


def phase_round_trip(flow, gen):
    with torch.no_grad():
        y, lq = flow.sample_and_log_prob(gen, (4096,))
        lp = flow.log_prob(y)
    e = compare("log_prob(y) vs sample_and_log_prob", lp, lq, ROUND_TRIP_TOL)
    say(7, f"round trip on the trained demo flow, 4096 samples: max abs "
           f"err {e:.3e}")


def main() -> int:
    smi = phase_device()
    import normalizingflows_torch  # noqa: F401  (fails outside a checkout)

    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    phase_build()
    kernels = phase_kernels(gen)
    phase_same_step(gen)
    flow, launches = phase_main_path(gen, name)
    phase_wide(gen, name)
    phase_round_trip(flow, gen)
    torch.cuda.synchronize()

    replaces = {"rqs_fwd": "normalizingflows/jl_tpu/ops/rqs_pallas.py:649",
                "rqs_bwd_fwddir":
                    "normalizingflows/jl_tpu/ops/rqs_pallas.py:717"}
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": "normalizingflows_torch/csrc/rqs.cu",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": kernels[k]["err"], "ms": kernels[k]["ms"],
         "plain_ms": kernels[k]["plain_ms"],
         "ms_demo": kernels[k]["ms_demo"],
         "plain_ms_demo": kernels[k]["plain_ms_demo"]}
        for k in ("rqs_fwd", "rqs_bwd_fwddir")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
