#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
``--phases 1,2,12,18-21`` runs only those phases (phase 1 always; 7 adds 5
and 15 adds 14, whose flows they take) and ends with the device line alone;
with no argument every phase runs. It builds the hand-written CUDA kernels
from ``normalizingflows_torch/csrc`` and drives the port's paths through
them: reverse-KL ELBO training of the
neural spline flow (K1 forward, K2), its density path, maximum-likelihood
training through `log_prob` (K1 inverse, K3), and RealNVP (K4, K5, from
phase 12 on):

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc of csrc/*.cu, one process per source, its seconds and
   ptxas's registers and spill bytes of every kernel instantiation (K1–K6:
   K5 and K6 in float32/float64 × H 16/32, K5 in both directions); a
   float32 K5 or K6 that spills fails;
3. kernels against their plain torch versions on the card: K1 forward and
   inverse, K2's and K3's gx/graw, at N = 64 (demo), 1000 (ragged) and
   131072 (wide), K 8 and 10, float32 and float64, raw read elem-major and
   param-major; raw padded to P = 3K−1+3 through K1/K2/K3 (pad gradient
   exactly 0, the rest equal to the unpadded call); the Pallas rows view
   (R=8, N/R=16384) through K1, equal to the flat param-major call; median
   device times of kernel and plain version at N = 64 and 131072;
4. one `elbo_from_samples` value-and-grad on the demo model with
   backend="cuda" and backend="plain" from identical parameters and draws;
5. the ELBO path: `train_flow` on the demo slice (nsf on Banana(2, 1, 100),
   64 samples, Adam(5e-4)) for 300 steps, with launch counts;
6. the wide configuration (d=64, hdims (128, 128), K=10, 10 layers, batch
   4096, float32) for 20 steps: steps/s and peak memory;
7. round trip: `log_prob(y)` through the inverse (K1) against
   `sample_and_log_prob`'s value on the trained demo flow;
8. one `loglikelihood` value-and-grad on the MLE demo flow, "cuda" against
   "plain" (K1 inverse and K3, no K2);
9. one `elbo_stl` value-and-grad on the ELBO demo, "cuda" against "plain"
   (K1 both directions, K2 and K3);
10. the density path: `train_flow_mle` on the MLE demo (the demo nsf on
    65,536 exact draws of Banana(2, 1, 10), batch 256, Adam(1e-3)) for 300
    steps: held-out mean log-likelihood before and after beside the
    target's E_p[log p], steps/s, launch counts;
11. MLE wide (d=64, hdims (128, 128), K=10, 10 layers, batch 4096, 65,536
    draws of Banana(64, 1, 10)) for 20 steps: steps/s and peak memory.

Then RealNVP (the fused coupling-stack kernels K4 `coupling_fwd` and K5
`coupling_bwd`, and the unfused module path beside them):

12. K4 and K5 against their plain versions (`tile_flow`, `tile_flow_bwd`)
    on the card: the demo model (d=2, [16,16]x3) at N 16, 300 and 262,144
    (K5's lane tile, then its row tile), the reference default
    ([32,32]x10) at N 256, d=5 with [8,8]x2 at N 300;
    float32 and float64, forward and inverse; y, ld, gx and every weight
    gradient; K4 and K5 twice with identical bits. Device times at N 16,
    256 and 262,144 of K4, K5 (both passes), the plain versions and the
    unfused `CouplingPairStack` forward and forward+backward on the same
    weights;
13. one `elbo_from_samples` value-and-grad on the demo through
    `realnvp(fused=True)` on the card, the same flow with backend "plain",
    and the unfused `realnvp` of the same seed (same weights);
14. the slice's main path: `train_flow` on `realnvp(2, (16, 16), nlayers=3,
    fused=True)` on Banana(2, 1, 100), `elbo_batch`, 16 samples,
    Adam(5e-4), 1,000 steps, with launch counts (one K4 and one K5 a
    step); then 1,000 steps of the unfused `realnvp` of the same seed;
15. sampling: `sample_and_log_prob` at batch 262,144 through K4 and through
    the unfused path (samples/s), and the round trip `log_prob(y)` (K4
    inverse) against `sample_and_log_prob`'s value;
16. the reference default `realnvp(2)` ([32,32]x10), batch 256, fused, 50
    steps: steps/s and launch counts;
17. wide unfused RealNVP (d=128, [256,256]x10, batch 4096, remat=True,
    float32) for 20 steps after 2: steps/s and peak memory, no kernel.

Then the whole-run training kernel K6 `realnvp_train` (many Adam/ELBO steps
of the fused stack a launch):

18. K6 against its plain version (`adam_train_plain`) on the card: 25 steps
    of the demo at batch 16, the reference default at batch 256 (8 row
    tiles in float32) and at batch 16 (one tile of 16 rows on 32 lanes
    each), and d=5 [8,8]x2 at batch 100 (a ragged tile), float32 and
    float64; the losses and every trained weight; K6 twice, and in chunks
    of 8 against one launch, with identical bits; the plain version's
    device time a step;
19. K6 against the eager K4/K5 step (`elbo_from_samples`, torch.optim.Adam)
    on the same 25 draws of the demo: the first loss and the trajectory;
20. the main path: `train_realnvp_fused` on the demo (1,000 steps, batch 16,
    Adam(5e-4)) in two K6 launches and no K4/K5 launch, steps/s and the
    device time of each launch (CUDA events), the ELBO beside phase 14's;
    then the reference default (batch 256, 50 steps);
21. the yardstick: one eager K4/K5 train step of the demo (base draws,
    forward, ELBO, backward, Adam(capturable=True)) captured in a CUDA
    graph and replayed 1,000 times: steps/s and device time a step.

Any failure raises, so the exit code is not 0. Without a CUDA device, or
outside a checkout of the repository, it fails before printing a result.
The last line of standard output is the device JSON; the line before it the
per-kernel JSON.
"""

from __future__ import annotations

import argparse
import copy
import functools
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

DEVICE = "cuda"
B = 30.0              # the NSF box half-width (nsf default)
SIZES = (64, 1000, 131072)
DEMO = dict(q0=2, hdims=(32, 32), K=10, B=B, nlayers=10, identity_init=True)
WIDE = dict(q0=64, hdims=(128, 128), K=10, B=B, nlayers=10,
            identity_init=True)
DEMO_STEPS, DEMO_BATCH, DEMO_LR = 300, 64, 5e-4
WIDE_STEPS, WIDE_BATCH, WIDE_LR = 20, 4096, 1e-3
# the density path: MLE on exact draws of Banana(d, 1, 10)
MLE_ROWS, MLE_HELD_OUT, MLE_LR = 65536, 8192, 1e-3
MLE_STEPS, MLE_BATCH = 300, 256
MLE_WIDE_STEPS, MLE_WIDE_BATCH = 20, 4096
# the card's published peaks (H100 SXM datasheet, at 700 W):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s
PEAK_BYTES_PER_S, PEAK_F32_PER_S = 3.35e12, 67e12
# RealNVP: the demo (bench.py:37-43, example/demo_RealNVP.jl), the
# reference default (`realnvp` defaults, Agrawal–Sheldon–Domke) and the wide
# GEMM-bound shape of the unfused path (benchmarks/roofline.py:180-193)
RNVP_DEMO = dict(q0=2, hdims=(16, 16), nlayers=3)
RNVP_REF = dict(q0=2, hdims=(32, 32), nlayers=10)
RNVP_ODD = dict(q0=5, hdims=(8, 8), nlayers=2)
RNVP_WIDE = dict(q0=128, hdims=(256, 256), nlayers=10, remat=True)
RNVP_STEPS, RNVP_BATCH, RNVP_LR = 1000, 16, 5e-4
RNVP_REF_STEPS, RNVP_REF_BATCH = 50, 256
RNVP_WIDE_STEPS, RNVP_WIDE_BATCH, RNVP_WIDE_LR = 20, 4096, 1e-3
SAMPLE_BATCH, SAMPLE_REPS = 262144, 10
# (model, N) of the phase-12 comparisons, and the (model, N) timed
CPL_SHAPES = (("demo", 16), ("demo", 300), ("demo", 262144), ("ref", 256),
              ("odd", 300))
CPL_TIMED = (("demo", 16), ("ref", 256), ("demo", 262144))
CPL_CFG = {"demo": RNVP_DEMO, "ref": RNVP_REF, "odd": RNVP_ODD}
KERNELS = ("rqs_fwd", "rqs_bwd_fwddir", "rqs_bwd_invdir")
CPL_KERNELS = ("coupling_fwd", "coupling_bwd")
# K6: (model, batch) of the phase-18 comparisons, their steps, and the
# reference default's steps on phase 20
TRAIN_SHAPES = (("demo", RNVP_BATCH), ("ref", RNVP_REF_BATCH),
                ("ref", RNVP_BATCH), ("odd", 100))
TRAIN_CMP_STEPS, TRAIN_REF_STEPS, GRAPH_STEPS = 25, 50, 1000
REPLACES = {
    "rqs_fwd": "normalizingflows/jl_tpu/ops/rqs_pallas.py:649, :541, :685",
    "rqs_bwd_fwddir": "normalizingflows/jl_tpu/ops/rqs_pallas.py:717, :576 "
                      "(forward direction)",
    "rqs_bwd_invdir": "normalizingflows/jl_tpu/ops/rqs_pallas.py:717, :576 "
                      "(inverse direction)",
    "coupling_fwd": "normalizingflows/jl_tpu/experimental/coupling_pallas.py"
                    ":371",
    "coupling_bwd": "normalizingflows/jl_tpu/experimental/coupling_pallas.py"
                    ":438",
    "realnvp_train": "normalizingflows/jl_tpu/experimental/train_pallas.py"
                     ":254",
}
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
# K4/K5 against their plain versions use TOL too: in float32 they are also
# the JAX suite's fused-coupling tolerances (tests/test_coupling_kernel.py
# :35-36, 65, 80). Not bit for bit here: the plain version's matmuls go
# through cuBLAS and sum in another order. The cotangents are those of a
# mean over the batch (scaled by 1/N), as the ELBO's are, so the weight
# gradients' batch sums stay of order 1 at every N.
# K6 against its plain version: the training tolerances of
# tests/test_torch_coupling.py:54 (losses and trained weights); against the
# eager K4/K5 step with torch.optim.Adam: the bounds of
# tests/test_train_kernel.py:83-85 (first loss rel 1e-6, trajectory max
# |Δ|/(|loss| + 1) 5e-5).
TRAIN_TOL = {torch.float32: (1e-4, 1e-5), torch.float64: (1e-8, 1e-12)}
FIRST_LOSS_REL, TRAJECTORY_REL = 1e-6, 5e-5
ALL_PHASES = tuple(range(1, 22))


def parse_phases(text: str) -> tuple:
    """"1,2,12,18-21" -> (1, 2, 12, 18, 19, 20, 21); anything else than
    phases or ranges of phases 1..21 raises ValueError."""
    out = set()
    for part in text.split(","):
        lo, dash, hi = part.strip().partition("-")
        if not (lo.isdigit() and (hi.isdigit() or not dash)):
            raise ValueError(f"not a phase or a range of phases: {part!r}")
        a, b = int(lo), int(hi) if dash else int(lo)
        if not 1 <= a <= b <= ALL_PHASES[-1]:
            raise ValueError(f"phases run from 1 to {ALL_PHASES[-1]}: "
                             f"{part!r}")
        out.update(range(a, b + 1))
    return tuple(sorted(out))


def say(phase: int, msg: str):
    print(f"[phase {phase}] {msg}", flush=True)


def compare(name, got, want, tol, quiet=False) -> float:
    """Max abs error; raises if any element is outside rtol/atol."""
    got, want = got.detach().double(), want.detach().double()
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


@functools.cache
def _warmup_stream() -> torch.cuda.Stream:
    """One side stream for every capture's warmup: cuBLAS keeps a
    workspace for each stream it has run on, for the life of the process."""
    return torch.cuda.Stream()


def device_ms(fn, reps=7, inner=20) -> float:
    """Median over ``reps`` of the device time of one call of ``fn``.
    After a warmup, ``inner`` calls are captured once into a CUDA graph,
    which is replayed between two CUDA events: the time is the card's, not
    the host's launch cost (tens of µs a call, more than the kernel)."""
    side = _warmup_stream()
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


def bound_ms(kernel: str, n: int, K: int, word_bytes: int):
    """The least time the card could take for one call on these inputs:
    bytes moved (each input read once, each output written once) over the
    memory rate, against operations over the float32 rate. K1 reads x and
    3K−1 raw words and writes y, ld: 3K+2 words an element; K2/K3 read x,
    raw, gy, gld and write gx, graw: 6K+2. Operations are counted from
    csrc/rqs.cu (each add, multiply, divide, compare, select, exp, log and
    sqrt as one): about 32K+35 an element for K1 (tables, bin, spline) and
    65K+100 for K2/K3 (the same tables, the closed-form reverse, two
    softmax/cumsum reverses, the softplus reverse)."""
    words, ops = ((3 * K + 2, 32 * K + 35) if kernel == "rqs_fwd"
                  else (6 * K + 2, 65 * K + 100))
    t_bytes = n * words * word_bytes / PEAK_BYTES_PER_S
    t_ops = n * ops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def launch_counts(rqs_cuda) -> dict:
    return {"rqs_fwd": rqs_cuda.FWD_LAUNCHES,
            "rqs_bwd_fwddir": rqs_cuda.BWD_LAUNCHES,
            "rqs_bwd_invdir": rqs_cuda.BWD_INV_LAUNCHES}


def all_counts() -> dict:
    """Every kernel's launch count: the RQS, the coupling and the training
    ones."""
    from normalizingflows_torch.experimental import coupling_cuda as cc
    from normalizingflows_torch.experimental import train_cuda as tc
    from normalizingflows_torch.ops import rqs_cuda

    return {**launch_counts(rqs_cuda),
            "coupling_fwd": cc.COUPLING_FWD_LAUNCHES,
            "coupling_bwd": cc.COUPLING_BWD_LAUNCHES,
            "realnvp_train": tc.TRAIN_LAUNCHES}


def reset_counts():
    """Every kernel's launch count to 0."""
    from normalizingflows_torch.experimental import coupling_cuda as cc
    from normalizingflows_torch.experimental import train_cuda as tc
    from normalizingflows_torch.ops import rqs_cuda

    rqs_cuda.FWD_LAUNCHES = rqs_cuda.BWD_LAUNCHES = 0
    rqs_cuda.BWD_INV_LAUNCHES = 0
    cc.COUPLING_FWD_LAUNCHES = cc.COUPLING_BWD_LAUNCHES = 0
    tc.TRAIN_LAUNCHES = 0


def expect_counts(label: str, **want):
    """Raise unless every kernel's count since the last reset is ``want``'s
    (0 for a kernel it does not name)."""
    got = all_counts()
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{label}: launches {got}, expected {full}")
    return got


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


# a kernel's mangled name in ptxas's report: its name, its type (f or d),
# then its bool (Lb0/Lb1: INVERSE) and int (Li16: H, or K for RQS)
# template arguments in order
_KERNEL_NAME = re.compile(r"(coupling_bwd_reduce|coupling_bwd_rows|"
                          r"coupling_bwd|coupling_fwd|"
                          r"realnvp_train|rqs_fwd|rqs_bwd_fwddir|"
                          r"rqs_bwd_invdir)I([fd])((?:L[bi]\d+E)*)")


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    entry function in nvcc's -Xptxas -v log, the kernel spelled as
    name<type, K=.., fwd/inv, H=..>."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = _KERNEL_NAME.search(line)
            name = None
            if m:
                kind, t, rest = m.groups()
                args = ["f32" if t == "f" else "f64"]
                for flag, value in re.findall(r"L([bi])(\d+)E", rest):
                    args.append(("inv" if value == "1" else "fwd")
                                if flag == "b" else
                                f"{'K' if kind.startswith('rqs') else 'H'}"
                                f"={value}")
                name = f"{kind}<{', '.join(args)}>"
            spills = (0, 0)
        elif "spill stores" in line and name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            spills = (int(m.group(1)), int(m.group(2)))
        elif "Used" in line and "registers" in line and name:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((name, regs, *spills))
            name = None
    return out


def phase_build():
    from normalizingflows_torch.ops import _build

    build = _build.build()
    say(2, f"nvcc {build.seconds:.1f} s -> {build.path.name}")
    report = ptxas_report(build.log)
    for kernel, regs, stores, loads in sorted(set(report)):
        print(f"    {kernel}: {regs} registers, {stores} bytes spill stores, "
              f"{loads} bytes spill loads", flush=True)
    if build.log and not any(k.startswith("coupling_bwd<") for k, *_ in
                             report):
        raise AssertionError("no K5 instantiation in ptxas's report")
    spilled = [k for k, _, stores, _ in report if stores and "f32" in k
               and k.startswith(("coupling_bwd", "realnvp_train<"))]
    if spilled:
        raise AssertionError(f"float32 K5/K6 spill registers: {spilled}")
    _build.library()


def _same(name, got, want):
    """Bit-for-bit equality of two tensors of one computation."""
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not identical")


def _grads(fused, x, raw, gy, gld):
    """(y, ld, gx, graw) of ``fused(x, raw)`` under cotangents (gy, gld)."""
    xg = x.detach().requires_grad_()
    rg = raw.detach().requires_grad_()
    y, ld = fused(xg, rg)
    return (y.detach(), ld.detach()) + torch.autograd.grad(
        (y, ld), (xg, rg), (gy.reshape(y.shape), gld.reshape(y.shape)))


def phase_kernels(gen):
    """K1 (forward, inverse), K2 and K3 against the plain tiles on the
    card; padded elem-major raw and the rows view; device times."""
    from normalizingflows_torch.ops import rqs_cuda

    results = {k: {"err": 0.0} for k in KERNELS}
    errs = []  # every kernel-vs-plain comparison's max abs error
    bwd_tile = {False: ("K2", "rqs_bwd_fwddir", rqs_cuda.tile_bwd_analytic),
                True: ("K3", "rqs_bwd_invdir",
                       rqs_cuda.tile_bwd_analytic_inverse)}
    checks = 0
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
                gy = torch.randn((n,), generator=gen, device=DEVICE,
                                 dtype=dtype)
                gld = torch.randn((n,), generator=gen, device=DEVICE,
                                  dtype=dtype)
                # the same raw padded to P + 3 columns, read elem-major
                raw_pad = torch.cat([rawf, torch.randn(
                    (n, 3), generator=gen, device=DEVICE, dtype=dtype)], 1)
                tag = f"{str(dtype)[6:]} K={K} N={n}"
                main = dtype == torch.float32 and K == 10 and n != 1000
                for inverse in (False, True):
                    d = "inv" if inverse else "fwd"
                    y, ld = rqs_cuda.rqs_fused(x, raw3, B, inverse=inverse,
                                               backend="cuda")
                    y_p, ld_p = rqs_cuda.tile_transform(xf, rawf, B, inverse)
                    errs += [compare(f"K1 {d} y  {tag}", y.reshape(-1), y_p,
                                     tol["y"]),
                             compare(f"K1 {d} ld {tag}", ld.reshape(-1),
                                     ld_p, tol["ld"])]
                    e = max(errs[-2:])
                    if main:
                        results["rqs_fwd"]["err"] = max(
                            results["rqs_fwd"]["err"], e)

                    kname, kkey, tile = bwd_tile[inverse]
                    gx, graw = _grads(lambda a, r: rqs_cuda.rqs_fused(
                        a, r, B, inverse=inverse, backend="cuda"),
                        x, raw3, gy, gld)[2:]
                    gx_p, graw_p = tile(xf, rawf, gy, gld, B)
                    errs += [compare(f"{kname} gx   {tag}", gx.reshape(-1),
                                     gx_p, tol["g"]),
                             compare(f"{kname} graw {tag}",
                                     graw.reshape(-1, P), graw_p, tol["g"])]
                    e = max(errs[-2:])
                    if main:
                        results[kkey]["err"] = max(results[kkey]["err"], e)

                    # param-major read of the same numbers (rqs_fused_t):
                    # identical values, graw back param-major
                    y_t, ld_t, gx_t, graw_t = _grads(
                        lambda a, r: rqs_cuda.rqs_fused_t(
                            a, r, B, inverse=inverse, backend="cuda"),
                        xf, rawf.T.contiguous(), gy, gld)
                    _same(f"K1 {d} {tag} param-major y", y_t, y.reshape(-1))
                    _same(f"K1 {d} {tag} param-major ld", ld_t,
                          ld.reshape(-1))
                    _same(f"{kname} {tag} param-major gx", gx_t,
                          gx.reshape(-1))
                    _same(f"{kname} {tag} param-major graw", graw_t.T,
                          graw.reshape(-1, P))

                    # padded elem-major (rqs_fused_e): pad ignored, its
                    # gradient written as exact zeros over poisoned memory
                    del graw_t
                    poison = torch.full_like(raw_pad, float("nan"))
                    del poison  # the allocator hands this block to graw
                    y_e, ld_e, gx_e, graw_e = _grads(
                        lambda a, r: rqs_cuda.rqs_fused_e(
                            a, r, B, K, inverse=inverse, backend="cuda"),
                        xf, raw_pad, gy, gld)
                    _same(f"K1 {d} {tag} padded y", y_e, y.reshape(-1))
                    _same(f"K1 {d} {tag} padded ld", ld_e, ld.reshape(-1))
                    _same(f"{kname} {tag} padded gx", gx_e, gx.reshape(-1))
                    _same(f"{kname} {tag} padded graw", graw_e[:, :P],
                          graw.reshape(-1, P))
                    if torch.count_nonzero(graw_e[:, P:]) or not bool(
                            torch.isfinite(graw_e[:, P:]).all()):
                        raise AssertionError(f"{kname} {tag}: pad columns "
                                             "of graw are not exact zeros")
                    checks += 12
            # the Pallas rows view (`_call_fwd_rows`): x (R, N/R), raw
            # (3K−1, R, N/R); K1 over its flattened and its permuted view
            R, L = 8, 131072 // 8
            x_rows = (torch.rand((R, L), generator=gen, device=DEVICE,
                                 dtype=dtype) * 3.0 - 1.5) * B
            raw_rows = 3.0 * torch.randn((P, R, L), generator=gen,
                                         device=DEVICE, dtype=dtype)
            for inverse in (False, True):
                flat = rqs_cuda.rqs_fused_t(
                    x_rows.reshape(-1), raw_rows.reshape(P, -1), B,
                    inverse=inverse, backend="cuda")
                view = rqs_cuda.rqs_fused(x_rows, raw_rows.permute(1, 2, 0),
                                          B, inverse=inverse, backend="cuda")
                tag = f"{str(dtype)[6:]} K={K} rows {R}x{L}"
                _same(f"K1 {tag} y", view[0].reshape(-1), flat[0])
                _same(f"K1 {tag} ld", view[1].reshape(-1), flat[1])
                checks += 2
    torch.cuda.synchronize()
    say(3, f"{sum(e == 0.0 for e in errs)} of {len(errs)} kernel-vs-plain "
           f"comparisons exact (max abs err 0), all within tolerance; "
           f"{checks} layout checks identical: param-major read, padded "
           f"elem-major (pad gradient exactly 0), rows view")

    # times at the demo and wide shapes, float32, K=10
    K = 10
    for n in (64, 131072):
        n_t = 32 if n == 131072 else 1
        batch, P = n // n_t, 3 * K - 1
        x = (torch.rand((n,), generator=gen, device=DEVICE) * 3 - 1.5) * B
        raw = 3.0 * torch.randn((batch, n_t * P), generator=gen,
                                device=DEVICE).view(n, P)
        gy = torch.randn((n,), generator=gen, device=DEVICE)
        gld = torch.randn((n,), generator=gen, device=DEVICE)
        t = {
            "rqs_fwd": (
                device_ms(lambda: rqs_cuda._launch_fwd(x, raw, B, K, False)),
                device_ms(lambda: rqs_cuda.tile_transform(x, raw, B))),
            "rqs_fwd inverse": (
                device_ms(lambda: rqs_cuda._launch_fwd(x, raw, B, K, True)),
                device_ms(lambda: rqs_cuda.tile_transform(x, raw, B, True))),
            "rqs_bwd_fwddir": (
                device_ms(lambda: rqs_cuda._launch_bwd(x, raw, gy, gld, B, K,
                                                       False)),
                device_ms(lambda: rqs_cuda.tile_bwd_analytic(
                    x, raw, gy, gld, B))),
            "rqs_bwd_invdir": (
                device_ms(lambda: rqs_cuda._launch_bwd(x, raw, gy, gld, B, K,
                                                       True)),
                device_ms(lambda: rqs_cuda.tile_bwd_analytic_inverse(
                    x, raw, gy, gld, B))),
        }
        for name, (ms, plain_ms) in t.items():
            kernel = name.split()[0]
            bms, by = bound_ms(kernel, n, K, 4)
            if name in results:
                key = "" if n == 131072 else "_demo"
                results[name].update({"ms" + key: ms,
                                      "plain_ms" + key: plain_ms,
                                      "bound_ms" + key: bms, "bound_by": by})
            say(3, f"{name} N={n} f32 K=10: kernel {ms:.5f} ms, plain "
                   f"{plain_ms:.5f} ms, bound {bms:.5f} ms ({by}) (device "
                   f"time a call: median of 7 CUDA-graph replays of 20 "
                   f"calls, CUDA events)")
    return results


def _demo_flow(backend="auto", seed=0):
    import normalizingflows_torch as nft

    # no device argument: the port builds on the card by default
    return nft.nsf(torch.Generator().manual_seed(seed), backend=backend,
                   **DEMO)


def _perturbed(flow):
    """Noise 0.1 on every parameter: off the identity, where every term of
    the gradient is non-zero."""
    with torch.no_grad():
        noise = torch.Generator(device=DEVICE).manual_seed(2)
        for p in flow.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=noise, device=DEVICE))
    return flow


def _both_backends(phase, flow_c, objective, want):
    """One value-and-grad of ``objective(flow)`` on the "cuda" flow and on
    its copy with backend "plain": same value and gradients within
    STEP_TOL, and the launch counts (K1, K2, K3) ``want`` and none."""
    from normalizingflows_torch.ops import rqs_cuda

    flow_p = copy.deepcopy(flow_c)
    flow_p.bijector.bijectors[0].backend = "plain"
    out = {}
    for label, flow in (("cuda", flow_c), ("plain", flow_p)):
        reset_counts()
        loss = -objective(flow)
        loss.backward()
        torch.cuda.synchronize()
        launched = tuple(launch_counts(rqs_cuda).values())
        expected = want if label == "cuda" else (0, 0, 0)
        if launched != expected:
            raise AssertionError(f"{label} backend launched (K1, K2, K3) "
                                 f"{launched} times, expected {expected}")
        out[label] = (loss.detach(), {n: p.grad for n, p in
                                      flow.named_parameters()
                                      if p.grad is not None})
    compare("loss", out["cuda"][0].reshape(1), out["plain"][0].reshape(1),
            STEP_TOL)
    grads_c, grads_p = out["cuda"][1], out["plain"][1]
    # every conditioner W and b, and the base's loc and scale
    if set(grads_c) != set(grads_p) or len(grads_c) != 10 * 2 * 3 * 2 + 2:
        raise AssertionError("the two backends differ in which parameters "
                             "got gradients")
    worst = max(compare(f"grad {n}", grads_c[n], grads_p[n], STEP_TOL,
                        quiet=True) for n in sorted(grads_c))
    say(phase, f"loss {float(out['cuda'][0]):.6f} on both backends; "
               f"{len(grads_c)} gradients agree (max abs err {worst:.3e}); "
               f"the cuda pass launched (K1, K2, K3) {want}, the plain pass "
               f"none")


def phase_same_step(gen):
    """One ELBO value-and-grad, kernels against plain, same everything."""
    import normalizingflows_torch as nft

    flow = _perturbed(_demo_flow("cuda", seed=1))
    xs = flow.base.sample(gen, (DEMO_BATCH,)).detach()
    target = nft.Banana(2, 1.0, 100.0)
    per_step = 2 * DEMO["nlayers"]
    _both_backends(4, flow, lambda f: nft.elbo_from_samples(
        xs, f, target.log_prob), (per_step, per_step, 0))


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
    reset_counts()
    t0 = time.perf_counter()
    res = nft.train_flow(
        gen, nft.elbo_batch, flow, target.log_prob, DEMO_BATCH,
        max_iters=DEMO_STEPS, check_every=100, callback=callback,
        optimizer=lambda p: torch.optim.Adam(p, lr=DEMO_LR))
    t1 = time.perf_counter()
    launches = all_counts()

    losses = res.stats["loss"]
    if len(losses) != DEMO_STEPS or not torch.isfinite(
            torch.from_numpy(losses)).all():
        raise AssertionError("demo training gave non-finite losses")
    first, last = losses[:20].mean(), losses[-20:].mean()
    if not last < first:
        raise AssertionError(f"demo loss did not fall: {first} -> {last}")
    per_step = 2 * DEMO["nlayers"]
    want = {"rqs_fwd": per_step * DEMO_STEPS,
            "rqs_bwd_fwddir": per_step * DEMO_STEPS, "rqs_bwd_invdir": 0,
            "coupling_fwd": 0, "coupling_bwd": 0, "realnvp_train": 0}
    if launches != want:
        raise AssertionError(f"launches {launches} in {DEMO_STEPS} steps, "
                             f"expected {want}")
    steady = (stamps[-1][0] - stamps[0][0]) / (stamps[-1][1] - stamps[0][1])
    say(5, f"ELBO {-losses[0]:.4f} -> {-losses[-1]:.4f} (mean of first 20 "
           f"{-first:.4f}, last 20 {-last:.4f}); {DEMO_STEPS} steps in "
           f"{t1 - t0:.2f} s = {DEMO_STEPS / (t1 - t0):.1f} steps/s overall, "
           f"{steady:.1f} steps/s after the first chunk, on {name}")
    say(5, f"launches: rqs_fwd {launches['rqs_fwd']}, rqs_bwd_fwddir "
           f"{launches['rqs_bwd_fwddir']} ({per_step} each per step), "
           f"rqs_bwd_invdir {launches['rqs_bwd_invdir']}")
    return flow, launches


def phase_wide(gen, name):
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import rqs_cuda

    flow = nft.nsf(torch.Generator().manual_seed(3), **WIDE)
    target = nft.Banana(64, 1.0, 100.0)
    kw = dict(optimizer=lambda p: torch.optim.Adam(p, lr=WIDE_LR))
    warm = nft.train_flow(gen, nft.elbo_batch, flow, target.log_prob,
                          WIDE_BATCH, max_iters=2, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
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
    if tuple(launch_counts(rqs_cuda).values()) != (
            20 * WIDE_STEPS, 20 * WIDE_STEPS, 0):
        raise AssertionError("wide training did not launch K1 and K2 20x "
                             "each per step and K3 never")
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


def phase_loglikelihood(gen):
    """One `loglikelihood` value-and-grad on the MLE demo flow."""
    import normalizingflows_torch as nft

    ys = nft.Banana(2, 1.0, 10.0).sample(gen, (MLE_BATCH,))
    per_step = 2 * DEMO["nlayers"]
    _both_backends(8, _perturbed(_demo_flow("cuda", seed=4)),
                   lambda f: nft.loglikelihood(f, ys), (per_step, 0, per_step))


def phase_stl():
    """One `elbo_stl` value-and-grad on the ELBO demo: both backends draw
    the same base samples from generators of one seed."""
    import normalizingflows_torch as nft

    target = nft.Banana(2, 1.0, 100.0)
    per_step = 2 * DEMO["nlayers"]
    _both_backends(9, _perturbed(_demo_flow("cuda", seed=5)),
                   lambda f: nft.elbo_stl(
                       torch.Generator(device=DEVICE).manual_seed(6), f,
                       target.log_prob, DEMO_BATCH),
                   (2 * per_step, per_step, per_step))


def _mle_data(gen, dim):
    """Exact draws of Banana(dim, 1, 10), made on the card: the training
    set (as the loader's numpy array) and a held-out set."""
    import normalizingflows_torch as nft

    target = nft.Banana(dim, 1.0, 10.0)
    train = target.sample(gen, (MLE_ROWS,)).cpu().numpy()
    return target, train, target.sample(gen, (MLE_HELD_OUT,))


def phase_mle(gen, name):
    """train_flow_mle on the MLE demo: the density path."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import rqs_cuda

    target, train, held = _mle_data(gen, 2)
    flow = _demo_flow()
    with torch.no_grad():
        ceiling = float(target.log_prob(held).mean())
        before = float(flow.log_prob(held).mean())
    stamps = []

    def callback(it, stat, f):
        stamps.append((it, time.perf_counter()))  # after the chunk's fetch

    loader = nft.utils.data.make_loader(train, MLE_BATCH, seed=0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = nft.train_flow_mle(
        flow, loader, max_iters=MLE_STEPS, check_every=100,
        callback=callback,
        optimizer=lambda p: torch.optim.Adam(p, lr=MLE_LR))
    t1 = time.perf_counter()
    launches = all_counts()
    with torch.no_grad():
        after = float(flow.log_prob(held).mean())

    losses = res.stats["loss"]
    if len(losses) != MLE_STEPS or not torch.isfinite(
            torch.from_numpy(losses)).all():
        raise AssertionError("MLE training gave non-finite losses")
    if not (torch.isfinite(torch.tensor([before, after])).all()
            and after > before):
        raise AssertionError(f"held-out log-likelihood did not rise: "
                             f"{before} -> {after}")
    per_step = 2 * DEMO["nlayers"]
    want = {"rqs_fwd": per_step * MLE_STEPS, "rqs_bwd_fwddir": 0,
            "rqs_bwd_invdir": per_step * MLE_STEPS, "coupling_fwd": 0,
            "coupling_bwd": 0, "realnvp_train": 0}
    if launches != want:
        raise AssertionError(f"launches {launches} in {MLE_STEPS} steps, "
                             f"expected {want}")
    steady = (stamps[-1][0] - stamps[0][0]) / (stamps[-1][1] - stamps[0][1])
    say(10, f"held-out mean log-likelihood ({MLE_HELD_OUT} fresh draws) "
            f"{before:.4f} -> {after:.4f}; the target's E_p[log p] on them "
            f"{ceiling:.4f} (the ceiling); train loss, mean of the first 20 "
            f"batches {losses[:20].mean():.4f}, of the last 20 "
            f"{losses[-20:].mean():.4f}; {MLE_STEPS} steps in "
            f"{t1 - t0:.2f} s = {MLE_STEPS / (t1 - t0):.1f} steps/s overall, "
            f"{steady:.1f} "
            f"steps/s after the first chunk, on {name}")
    say(10, f"launches: rqs_fwd {launches['rqs_fwd']}, rqs_bwd_invdir "
            f"{launches['rqs_bwd_invdir']} ({per_step} each per step), "
            f"rqs_bwd_fwddir {launches['rqs_bwd_fwddir']}")
    return launches


def phase_mle_wide(gen, name):
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import rqs_cuda

    _, train, _ = _mle_data(gen, 64)
    flow = nft.nsf(torch.Generator().manual_seed(7), **WIDE)
    loader = nft.utils.data.make_loader(train, MLE_WIDE_BATCH, seed=0)
    kw = dict(optimizer=lambda p: torch.optim.Adam(p, lr=MLE_LR))
    warm = nft.train_flow_mle(flow, loader, max_iters=2, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = nft.train_flow_mle(flow, loader, max_iters=MLE_WIDE_STEPS,
                             check_every=MLE_WIDE_STEPS,
                             resume_state=warm.state, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = tuple(launch_counts(rqs_cuda).values())
    losses = res.stats["loss"]
    if not torch.isfinite(torch.from_numpy(losses)).all():
        raise AssertionError("MLE wide training gave non-finite losses")
    if launches != (20 * MLE_WIDE_STEPS, 0, 20 * MLE_WIDE_STEPS):
        raise AssertionError(f"MLE wide launched (K1, K2, K3) {launches}, "
                             "expected 20 K1 and 20 K3 per step")
    say(11, f"MLE wide f32 d=64 [128,128]x10 K=10 batch {MLE_WIDE_BATCH}: "
            f"{MLE_WIDE_STEPS} steps in {dt:.3f} s = "
            f"{MLE_WIDE_STEPS / dt:.2f} steps/s, peak memory "
            f"{peak / 2**20:.1f} MiB, loss {losses[0]:.2f} -> "
            f"{losses[-1]:.2f}, launches (K1, K2, K3) {launches}, on {name}")


# ---------------------------------------------------------------------------
# RealNVP: the fused coupling-stack kernels K4/K5 and the unfused path
# ---------------------------------------------------------------------------

def rnvp_n_params(cfg: dict) -> int:
    """The weights of a RealNVP stack of ``cfg``: per coupling and net, a
    Dense chain n_B → hidden... → n_A."""
    d, hdims, L = cfg["q0"], cfg["hdims"], cfg["nlayers"]
    n = 0
    for n_a in ((d + 1) // 2, d // 2):
        widths = [d - n_a, *hdims, n_a]
        n += L * 2 * sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    return n


def coupling_work(kernel: str, cfg: dict, n: int, word_bytes: int):
    """(operations, bytes) one call of K4 or K5 needs on n rows, counted
    from csrc/coupling.cu. Per coupling and net: a multiply and an add per
    weight (MACs), a bias add and an activation per unit; per transformed
    element an exp, a multiply, an add and the log-det add. K5's work is
    the VJP's: one forward (the kernel runs it twice, once keeping each
    coupling's input and once rebuilding its caches, but the second is its
    choice, not the function's), then per layer the weight gradient Hᵀ·G
    and the input cotangent G·Wᵀ (a MAC each per weight and row), the slope
    and the bias gradient per unit, and ~6 operations per transformed
    element. Bytes:
    K4 reads x and the weights and writes y and ld; K5 reads x, gy, gld and
    the weights and writes gx and the weight gradients."""
    d, hdims, L = cfg["q0"], cfg["hdims"], cfg["nlayers"]
    ops, n_params = 0, rnvp_n_params(cfg)
    for n_a in ((d + 1) // 2, d // 2):
        widths = [d - n_a, *hdims, n_a]
        macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
        units = sum(widths[1:])
        fwd = 2 * (2 * macs + 2 * units) + 4 * n_a
        if kernel == "coupling_fwd":
            ops += L * fwd
        else:
            ops += L * (fwd + 2 * (4 * macs + 2 * units) + 6 * n_a)
    if kernel == "coupling_fwd":
        words = n * (2 * d + 1) + n_params
    else:
        words = n * (3 * d + 1) + 2 * n_params
    return n * ops, words * word_bytes


def coupling_bound_ms(kernel: str, cfg: dict, n: int):
    """The float32 bound (the timed shapes are float32)."""
    ops, nbytes = coupling_work(kernel, cfg, n, 4)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _rnvp(cfg: dict, seed: int, fused: bool, dtype=torch.float32):
    import normalizingflows_torch as nft

    # no device argument: the port builds on the card by default
    return nft.realnvp(torch.Generator().manual_seed(seed), fused=fused,
                       dtype=dtype, **cfg)


def _stack_grads(stack, grp: str, net: str, li: int):
    """The unfused stack's (W, b) gradients of one conditioner layer,
    stacked over blocks like the fused flow's."""
    return [torch.stack([getattr(m.layers[li], k).grad
                         for m in stack.stacked[f"{net}_{grp}"]])
            for k in ("W", "b")]


def _unfused_like(fb, cfg: dict, dtype):
    """An unfused `CouplingPairStack` holding the fused flow's weights."""
    stack = _rnvp(cfg, 0, False, dtype).bijector.bijectors[0]
    with torch.no_grad():
        for grp in ("even", "odd"):
            for net in ("s", "t"):
                for li, (W, b) in enumerate(fb.groups[grp][net]):
                    for i, m in enumerate(stack.stacked[f"{net}_{grp}"]):
                        m.layers[li].W.copy_(W[i])
                        m.layers[li].b.copy_(b[i])
    return stack


def _cpl_run(cc, x, fb, gy, gld, inverse):
    """(y, ld, gx, *weight grads) through `coupling_stack_fused` on the
    card: one K4 launch and one K5 call."""
    leaves = cc._leaves(fb.groups)
    xg = x.detach().requires_grad_()
    y, ld = cc.coupling_stack_fused(xg, fb.groups, fb.idx_even, fb.idx_odd,
                                    inverse=inverse, backend="cuda")
    grads = torch.autograd.grad((y, ld), [xg] + leaves, (gy, gld))
    return [y.detach(), ld.detach(), *grads]


def phase_coupling_kernels(gen):
    """K4 and K5 against their plain versions on the card; device times."""
    from normalizingflows_torch.experimental import coupling_cuda as cc

    results = {k: {"err": 0.0, "ms_by_n": {}, "plain_ms_by_n": {},
                   "bound_ms_by_n": {}, "unfused_ms_by_n": {}}
               for k in CPL_KERNELS}
    n_cmp = 0
    flows = {}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        for model, n in CPL_SHAPES:
            cfg = CPL_CFG[model]
            if (model, dtype) not in flows:
                flow = _perturbed(_rnvp(cfg, 30, True, dtype))
                flows[(model, dtype)] = flow.bijector.bijectors[0]
            fb = flows[(model, dtype)]
            d = cfg["q0"]
            sels = cc._sels(fb.idx_even, fb.idx_odd, d)
            x = torch.randn((n, d), generator=gen, device=DEVICE, dtype=dtype)
            gy = torch.randn((n, d), generator=gen, device=DEVICE,
                             dtype=dtype) / n
            gld = torch.randn((n,), generator=gen, device=DEVICE,
                              dtype=dtype) / n
            tag = f"{str(dtype)[6:]} {model} N={n}"
            for inverse in (False, True):
                dr = "inv" if inverse else "fwd"
                got = _cpl_run(cc, x, fb, gy, gld, inverse)
                again = _cpl_run(cc, x, fb, gy, gld, inverse)
                for i, (a, b) in enumerate(zip(got, again)):
                    _same(f"K4/K5 {dr} {tag} output {i}, two runs", a, b)
                y_p, ld_p = cc.tile_flow(x, fb.groups, sels, inverse)
                gx_p, tree = cc.tile_flow_bwd(x, fb.groups, gy, gld, sels,
                                              inverse)
                e4 = max(compare(f"K4 {dr} y  {tag}", got[0], y_p, tol["y"]),
                         compare(f"K4 {dr} ld {tag}", got[1], ld_p,
                                 tol["ld"]))
                # gy and gld are scaled by 1/n (the weight gradients are
                # means); gx is per row, so its atol is scaled with them
                gx_tol = (tol["g"][0], tol["g"][1] / n)
                e5 = max(compare(f"K5 {dr} {tag} {name}", a, b,
                                 gx_tol if name == "gx" else tol["g"],
                                 quiet=name != "gx")
                         for name, a, b in zip(
                             ["gx"] + [f"leaf {i}" for i in
                                       range(len(got) - 3)],
                             got[2:], [gx_p] + cc._leaves(tree)))
                n_cmp += len(got)
                if dtype == torch.float32 and model == "demo":
                    results["coupling_fwd"]["err"] = max(
                        results["coupling_fwd"]["err"], e4)
                    results["coupling_bwd"]["err"] = max(
                        results["coupling_bwd"]["err"], e5)
    torch.cuda.synchronize()
    say(12, f"{n_cmp} K4/K5-vs-plain comparisons within tolerance (float32 "
            f"and float64, forward and inverse, y, ld, gx and every weight "
            f"gradient); K4 (y, ld) and K5 (gx, every weight gradient) gave "
            f"identical bits on two runs each")

    for model, n in CPL_TIMED:
        cfg = CPL_CFG[model]
        fb = flows[(model, torch.float32)]
        d, depth = cfg["q0"], len(cfg["hdims"]) + 1
        sels = cc._sels(fb.idx_even, fb.idx_odd, d)
        leaves = cc._leaves(fb.groups)
        stack = _unfused_like(fb, cfg, torch.float32)
        params = list(stack.parameters())
        x = torch.randn((n, d), generator=gen, device=DEVICE)
        xg = x.clone().requires_grad_()
        gy = torch.randn((n, d), generator=gen, device=DEVICE) / n
        gld = torch.randn((n,), generator=gen, device=DEVICE) / n

        def unfused_fwd():
            with torch.no_grad():
                return stack.forward_and_log_det(x)

        def unfused_fwd_bwd():
            y, ld = stack.forward_and_log_det(xg)
            return torch.autograd.grad((y, ld), [xg] + params, (gy, gld))

        t = {"coupling_fwd": (
                 device_ms(lambda: cc._launch_fwd(x, leaves, sels, depth,
                                                  False)),
                 device_ms(lambda: cc.tile_flow(x, fb.groups, sels)),
                 device_ms(unfused_fwd)),
             "coupling_bwd": (
                 device_ms(lambda: cc._launch_bwd(x, leaves, gy, gld, sels,
                                                  depth, False)),
                 device_ms(lambda: cc.tile_flow_bwd(x, fb.groups, gy, gld,
                                                    sels)),
                 device_ms(unfused_fwd_bwd))}
        for k, (ms, plain_ms, unfused_ms) in t.items():
            bms, by = coupling_bound_ms(k, cfg, n)
            key = str(n)
            results[k]["ms_by_n"][key] = ms
            results[k]["plain_ms_by_n"][key] = plain_ms
            results[k]["bound_ms_by_n"][key] = bms
            results[k]["unfused_ms_by_n"][key] = unfused_ms
            results[k].setdefault("bound_by_n", {})[key] = by
            what = ("forward" if k == "coupling_fwd"
                    else "forward+backward")
            say(12, f"{k} {model} N={n} f32: kernel {ms:.5f} ms, plain "
                    f"{plain_ms:.5f} ms, unfused {what} {unfused_ms:.5f} ms, "
                    f"bound {bms:.5f} ms ({by}) (device time a call: median "
                    f"of 7 CUDA-graph replays of 20 calls, CUDA events)")
    for k in CPL_KERNELS:
        r = results[k]
        main = str(RNVP_BATCH)
        r.update(ms=r["ms_by_n"][main], plain_ms=r["plain_ms_by_n"][main],
                 bound_ms=r["bound_ms_by_n"][main],
                 bound_by=r["bound_by_n"][main],
                 unfused_ms=r["unfused_ms_by_n"][main])
    return results


def phase_rnvp_same_step(gen):
    """One ELBO value-and-grad through the fused flow on the card, the same
    flow on the plain versions, and the unfused flow of the same seed."""
    import normalizingflows_torch as nft

    fused = _rnvp(RNVP_DEMO, 21, True)
    plain = copy.deepcopy(fused)
    plain.bijector.bijectors[0].backend = "plain"
    unfused = _rnvp(RNVP_DEMO, 21, False)
    fb, stack = fused.bijector.bijectors[0], unfused.bijector.bijectors[0]
    for grp in ("even", "odd"):
        for net in ("s", "t"):
            for li, (W, _) in enumerate(fb.groups[grp][net]):
                for i, m in enumerate(stack.stacked[f"{net}_{grp}"]):
                    _same(f"weights {grp} {net} {li} block {i}", W[i],
                          m.layers[li].W)
    xs = fused.base.sample(gen, (RNVP_BATCH,)).detach()
    target = nft.Banana(2, 1.0, 100.0)
    out = {}
    for label, flow, want in (
            ("fused cuda", fused, dict(coupling_fwd=1, coupling_bwd=1)),
            ("fused plain", plain, {}), ("unfused", unfused, {})):
        reset_counts()
        loss = -nft.elbo_from_samples(xs, flow, target.log_prob)
        loss.backward()
        torch.cuda.synchronize()
        expect_counts(f"phase 13, {label}", **want)
        out[label] = loss.detach()
    for label in ("fused plain", "unfused"):
        compare(f"loss, fused cuda vs {label}",
                out["fused cuda"].reshape(1), out[label].reshape(1), STEP_TOL)
    worst, count = 0.0, 0
    fbp = plain.bijector.bijectors[0]
    for grp in ("even", "odd"):
        for net in ("s", "t"):
            for li in range(len(fb.groups[grp][net])):
                ref = _stack_grads(stack, grp, net, li)
                for k in (0, 1):
                    got = fb.groups[grp][net][li][k].grad
                    for want in (fbp.groups[grp][net][li][k].grad, ref[k]):
                        worst = max(worst, compare(
                            f"grad {grp} {net} {li} {k}", got, want,
                            STEP_TOL, quiet=True))
                    count += 1
    for name in ("loc", "scale"):
        got = getattr(fused.base, name).grad
        for flow in (plain, unfused):
            worst = max(worst, compare(f"grad base.{name}", got,
                                       getattr(flow.base, name).grad,
                                       STEP_TOL, quiet=True))
        count += 1
    say(13, f"loss {float(out['fused cuda']):.6f} on the three paths; "
            f"{count} gradients agree (max abs err {worst:.3e}); the fused "
            f"pass launched K4 once and K5 once, the others no kernel")


def _train_rate(flow, gen, target, batch, steps, lr, check_every):
    """train_flow with elbo_batch: (result, seconds, steps/s after the
    first chunk)."""
    import normalizingflows_torch as nft

    stamps = []

    def callback(it, stat, f):
        stamps.append((it, time.perf_counter()))  # after the chunk's fetch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = nft.train_flow(gen, nft.elbo_batch, flow, target.log_prob, batch,
                         max_iters=steps, check_every=check_every,
                         callback=callback,
                         optimizer=lambda p: torch.optim.Adam(p, lr=lr))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steady = ((stamps[-1][0] - stamps[0][0]) / (stamps[-1][1] - stamps[0][1])
              if len(stamps) > 1 else steps / dt)
    losses = res.stats["loss"]
    if len(losses) != steps or not torch.isfinite(
            torch.from_numpy(losses)).all():
        raise AssertionError("training gave non-finite losses")
    return res, dt, steady


def phase_rnvp_main(name):
    """The slice's main path: fused RealNVP demo training, then the unfused
    flow of the same seed on the same draws. Returns the flows, the fused
    run's launches and its ELBO and rate (for phase 20)."""
    import normalizingflows_torch as nft

    target = nft.Banana(2, 1.0, 100.0)
    flows, launches, summary = {}, None, None
    for fused in (True, False):
        flow = _rnvp(RNVP_DEMO, 0, fused)
        gen = torch.Generator(device=DEVICE).manual_seed(40)
        reset_counts()
        res, dt, steady = _train_rate(flow, gen, target, RNVP_BATCH,
                                      RNVP_STEPS, RNVP_LR, 100)
        want = (dict(coupling_fwd=RNVP_STEPS, coupling_bwd=RNVP_STEPS)
                if fused else {})
        counts = expect_counts("phase 14", **want)
        losses = res.stats["loss"]
        first, last = losses[:100].mean(), losses[-100:].mean()
        if not last < first:
            raise AssertionError(f"ELBO did not rise: {-first} -> {-last}")
        label = "fused" if fused else "unfused"
        say(14, f"{label}: ELBO {-losses[0]:.4f} -> {-losses[-1]:.4f} (mean "
                f"of first 100 {-first:.4f}, last 100 {-last:.4f}); "
                f"{RNVP_STEPS} steps in {dt:.2f} s = {RNVP_STEPS / dt:.1f} "
                f"steps/s overall, {steady:.1f} steps/s after the first "
                f"chunk, on {name}; launches {counts}")
        flows[label] = flow
        if fused:
            launches = counts
            summary = dict(first=-losses[0], last=-losses[-1],
                           first100=-first, last100=-last, steady=steady)
    return flows, launches, summary


def phase_rnvp_sampling(flows, gen, name):
    """sample_and_log_prob at batch 262,144 through K4 and unfused, and the
    round trip through K4's inverse."""
    rates = {}
    with torch.no_grad():
        for label, flow in flows.items():
            flow.sample_and_log_prob(gen, (SAMPLE_BATCH,))  # warm
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            for _ in range(SAMPLE_REPS):
                flow.sample_and_log_prob(gen, (SAMPLE_BATCH,))
            torch.cuda.synchronize()
            rates[label] = SAMPLE_REPS * SAMPLE_BATCH / (
                time.perf_counter() - t0)
            expect_counts(f"phase 15 {label}", **(
                dict(coupling_fwd=SAMPLE_REPS) if label == "fused" else {}))
        fused = flows["fused"]
        y, lq = fused.sample_and_log_prob(gen, (SAMPLE_BATCH,))
        lp = fused.log_prob(y)
        if y.shape != (SAMPLE_BATCH, 2) or not bool(torch.isfinite(y).all()):
            raise AssertionError("samples are not finite (262144, 2)")
    e = compare("log_prob(y) vs sample_and_log_prob", lp, lq, ROUND_TRIP_TOL)
    say(15, f"sample_and_log_prob, batch {SAMPLE_BATCH}, {SAMPLE_REPS} "
            f"calls: fused (K4) {rates['fused']:.4g} samples/s, unfused "
            f"{rates['unfused']:.4g} samples/s, on {name}; round trip "
            f"through K4's inverse: max abs err {e:.3e}")


def phase_rnvp_ref(gen, name):
    """The reference default realnvp(2): [32,32]x10, batch 256, fused."""
    import normalizingflows_torch as nft

    target = nft.Banana(2, 1.0, 100.0)
    flow = _rnvp(RNVP_REF, 50, True)
    _train_rate(flow, gen, target, RNVP_REF_BATCH, 5, RNVP_LR, 5)  # warm
    reset_counts()
    res, dt, _ = _train_rate(flow, gen, target, RNVP_REF_BATCH,
                             RNVP_REF_STEPS, RNVP_LR, RNVP_REF_STEPS)
    counts = expect_counts("phase 16", coupling_fwd=RNVP_REF_STEPS,
                           coupling_bwd=RNVP_REF_STEPS)
    losses = res.stats["loss"]
    say(16, f"reference default [32,32]x10, batch {RNVP_REF_BATCH}, fused: "
            f"{RNVP_REF_STEPS} steps in {dt:.3f} s = "
            f"{RNVP_REF_STEPS / dt:.1f} steps/s, loss {losses[0]:.2f} -> "
            f"{losses[-1]:.2f}, launches {counts}, on {name}")


def phase_rnvp_wide(gen, name):
    """Wide unfused RealNVP with remat: the GEMM-bound default path."""
    import normalizingflows_torch as nft

    target = nft.Banana(RNVP_WIDE["q0"], 1.0, 100.0)
    flow = _rnvp(RNVP_WIDE, 60, False)
    _train_rate(flow, gen, target, RNVP_WIDE_BATCH, 2, RNVP_WIDE_LR, 2)
    gc.collect()  # earlier phases' reference cycles (CUDA graphs, flows)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    res, dt, _ = _train_rate(flow, gen, target, RNVP_WIDE_BATCH,
                             RNVP_WIDE_STEPS, RNVP_WIDE_LR, RNVP_WIDE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    expect_counts("phase 17")
    losses = res.stats["loss"]
    cfg = RNVP_WIDE
    say(17, f"wide unfused f32 d={cfg['q0']} {list(cfg['hdims'])}x"
            f"{cfg['nlayers']} batch {RNVP_WIDE_BATCH} remat: "
            f"{RNVP_WIDE_STEPS} steps in {dt:.3f} s = "
            f"{RNVP_WIDE_STEPS / dt:.2f} steps/s, peak memory "
            f"{peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB of it held "
            f"before the run: the flow's weights and what earlier phases "
            f"keep), loss {losses[0]:.2f} -> "
            f"{losses[-1]:.2f}, no kernel launched, on {name}")


# ---------------------------------------------------------------------------
# The whole-run training kernel K6 and its yardsticks
# ---------------------------------------------------------------------------

def train_bound_ms(cfg: dict, n: int, launch_steps):
    """The float32 bound of one K6 step on n rows, for a run made of
    launches of ``launch_steps`` steps each: what each launch's function
    must move and do, over the run's steps. Bytes: its steps' draws read,
    one loss a step written, the weights and both Adam moments read once
    and written once (6 words a weight); the cotangents, the input
    cotangent and the weight gradients never leave the launch. Operations:
    K5's a step (one forward and the backward, `coupling_work`) plus Adam's
    14 a weight (the two moments, the bias corrections, the square root and
    the update)."""
    d, n_params = cfg["q0"], rnvp_n_params(cfg)
    steps = sum(launch_steps)
    ops = steps * (coupling_work("coupling_bwd", cfg, n, 4)[0]
                   + 14 * n_params)
    words = steps * (n * d + 1) + len(launch_steps) * 6 * n_params
    t_bytes, t_ops = 4 * words / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops) / steps, (
        "bytes" if t_bytes >= t_ops else "operations")


def _train_args(cfg: dict, dtype, batch: int, steps: int, seed: int, gen,
                perturb=True):
    """adam_train_realnvp_fused's arguments for a fused flow of ``cfg`` on
    the card and ``steps`` draws of its base: (flow, args)."""
    import normalizingflows_torch as nft

    flow = _rnvp(cfg, seed, True, dtype)
    if perturb:
        flow = _perturbed(flow)
    fb = flow.bijector.bijectors[0]
    xs = flow.base.sample(gen, (steps, batch)).detach()
    return flow, (xs, fb.groups, fb.idx_even, fb.idx_odd,
                  nft.Banana(cfg["q0"], 1.0, 100.0), flow.base.loc,
                  flow.base.scale, RNVP_LR)


def _train_outputs(res):
    from normalizingflows_torch.experimental import coupling_cuda as cc

    groups, losses = res
    return [losses] + cc._leaves(groups)


def phase_train_kernel(gen):
    """K6 against its plain version on the card; identical bits on two runs
    and across chunk sizes; the plain version's device time a step."""
    from normalizingflows_torch.experimental import train_cuda as tc

    err, n_cmp = 0.0, 0
    for dtype in (torch.float32, torch.float64):
        for model, batch in TRAIN_SHAPES:
            _, args = _train_args(CPL_CFG[model], dtype, batch,
                                  TRAIN_CMP_STEPS, 31, gen)
            tag = f"{str(dtype)[6:]} {model} batch {batch}"
            got = _train_outputs(tc.adam_train_realnvp_fused(
                *args, backend="cuda"))
            again = _train_outputs(tc.adam_train_realnvp_fused(
                *args, backend="cuda"))
            chunked = _train_outputs(tc.adam_train_realnvp_fused(
                *args, chunk=8, backend="cuda"))
            for i, (a, b, c) in enumerate(zip(got, again, chunked)):
                _same(f"K6 {tag} output {i}, two runs", a, b)
                _same(f"K6 {tag} output {i}, chunks of 8", a, c)
            want = _train_outputs(tc.adam_train_plain(*args))
            e = max(compare(f"K6 {tag} {'losses' if i == 0 else f'leaf {i}'}",
                            a, b, TRAIN_TOL[dtype], quiet=i > 0)
                    for i, (a, b) in enumerate(zip(got, want)))
            n_cmp += len(got)
            if dtype == torch.float32 and model == "demo":
                err = e
    torch.cuda.synchronize()
    say(18, f"{n_cmp} K6-vs-plain comparisons within tolerance (losses and "
            f"every trained weight, {TRAIN_CMP_STEPS} steps, float32 and "
            f"float64, demo, reference default at batch 256 and 16, d=5); K6 "
            f"gave identical bits on two runs and in chunks of 8 against one "
            f"launch")

    # the plain version's device time a step: 10 steps a call
    _, args = _train_args(RNVP_DEMO, torch.float32, RNVP_BATCH, 10, 32, gen)
    plain_ms = device_ms(lambda: tc.adam_train_plain(*args), reps=5,
                         inner=2) / 10
    say(18, f"adam_train_plain demo batch {RNVP_BATCH} f32: {plain_ms:.5f} ms "
            f"a step (device time: median of 5 CUDA-graph replays of 2 "
            f"calls of 10 steps, CUDA events)")
    return {"err": err, "plain_ms": plain_ms}


def phase_train_vs_eager(gen):
    """K6 against the eager K4/K5 step on the same draws."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.experimental import train_cuda as tc

    flow, args = _train_args(RNVP_DEMO, torch.float32, RNVP_BATCH,
                             TRAIN_CMP_STEPS, 33, gen, perturb=False)
    xs, target = args[0], args[4]
    reset_counts()
    _, losses = tc.adam_train_realnvp_fused(*args)
    torch.cuda.synchronize()
    expect_counts("phase 19, K6", realnvp_train=1)
    fb = flow.bijector.bijectors[0]
    opt = torch.optim.Adam(fb.parameters(), lr=RNVP_LR)
    eager = []
    reset_counts()
    for x in xs:
        opt.zero_grad(set_to_none=True)
        loss = -nft.elbo_from_samples(x, flow, target.log_prob)
        loss.backward()
        opt.step()
        eager.append(loss.detach())
    torch.cuda.synchronize()
    expect_counts("phase 19, eager", coupling_fwd=TRAIN_CMP_STEPS,
                  coupling_bwd=TRAIN_CMP_STEPS)
    eager = torch.stack(eager).double()
    losses = losses.double()
    first = float((losses[0] - eager[0]).abs() / eager[0].abs())
    traj = float(((losses - eager).abs() / (eager.abs() + 1.0)).max())
    if not (first < FIRST_LOSS_REL and traj < TRAJECTORY_REL):
        raise AssertionError(f"K6 against the eager step: first loss rel "
                             f"{first:.3e} (< {FIRST_LOSS_REL}), trajectory "
                             f"{traj:.3e} (< {TRAJECTORY_REL})")
    say(19, f"K6 against the eager K4/K5 step + torch.optim.Adam, "
            f"{TRAIN_CMP_STEPS} steps of the demo on the same draws: first "
            f"loss rel {first:.3e}, trajectory max |Δ|/(|loss|+1) "
            f"{traj:.3e}; loss {float(eager[0]):.4f} -> "
            f"{float(eager[-1]):.4f}")


def _timed_train(flow, gen, target, batch, steps):
    """train_realnvp_fused with CUDA events around each K6 launch: (result,
    host seconds, [device ms of each launch], [steps of each launch])."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.experimental import train_cuda as tc

    events, launch_steps = [], []
    launch = tc._launch_chunk

    def timed(fn, xs, w, m, v, grad, losses, run, step0, n, args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(fn, xs, w, m, v, grad, losses, run, step0, n, args)
        stop.record()
        events.append((start, stop))
        launch_steps.append(n)

    tc._launch_chunk = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = nft.train_realnvp_fused(gen, flow, target, batch,
                                      max_iters=steps, learning_rate=RNVP_LR)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        tc._launch_chunk = launch
    losses = res.stats["loss"]
    if losses.shape != (steps,) or not torch.isfinite(
            torch.from_numpy(losses)).all():
        raise AssertionError("whole-run training gave non-finite losses")
    return res, dt, [a.elapsed_time(b) for a, b in events], launch_steps


def phase_train_main(name, eager):
    """The slice's main path: the demo through train_realnvp_fused, then the
    reference default."""
    import normalizingflows_torch as nft

    target = nft.Banana(2, 1.0, 100.0)
    flow = _rnvp(RNVP_DEMO, 0, True)
    gen = torch.Generator(device=DEVICE).manual_seed(80)
    reset_counts()
    res, dt, launch_ms, launch_steps = _timed_train(
        flow, gen, target, RNVP_BATCH, RNVP_STEPS)
    counts = expect_counts("phase 20", realnvp_train=2)
    losses = res.stats["loss"]
    first, last = losses[:100].mean(), losses[-100:].mean()
    if not last < first:
        raise AssertionError(f"ELBO did not rise: {-first} -> {-last}")
    step_ms = sum(launch_ms) / RNVP_STEPS
    bms, by = train_bound_ms(RNVP_DEMO, RNVP_BATCH, launch_steps)
    say(20, f"train_realnvp_fused demo: ELBO {-losses[0]:.4f} -> "
            f"{-losses[-1]:.4f} (mean of first 100 {-first:.4f}, last 100 "
            f"{-last:.4f}); {RNVP_STEPS} steps in {dt:.4f} s = "
            f"{RNVP_STEPS / dt:.1f} steps/s; K6 launches of {launch_steps} "
            f"steps {launch_ms} ms (CUDA events) = {step_ms:.5f} ms a step "
            f"on the device, bound {bms:.3e} ms a step ({by}); launches "
            f"{counts}, on {name}")
    if eager:
        say(20, f"phase 14 (eager K4/K5, other draws): ELBO "
                f"{eager['first']:.4f} -> {eager['last']:.4f} (mean of first "
                f"100 {eager['first100']:.4f}, last 100 "
                f"{eager['last100']:.4f}), {eager['steady']:.1f} steps/s "
                f"after the first chunk")

    flow = _rnvp(RNVP_REF, 50, True)
    reset_counts()
    res_ref, dt_ref, ref_ms, ref_steps = _timed_train(
        flow, gen, target, RNVP_REF_BATCH, TRAIN_REF_STEPS)
    ref_counts = expect_counts("phase 20, reference default",
                               realnvp_train=1)
    ref_bms, ref_by = train_bound_ms(RNVP_REF, RNVP_REF_BATCH, ref_steps)
    losses = res_ref.stats["loss"]
    say(20, f"reference default [32,32]x10, batch {RNVP_REF_BATCH}: "
            f"{TRAIN_REF_STEPS} steps in {dt_ref:.4f} s = "
            f"{TRAIN_REF_STEPS / dt_ref:.1f} steps/s, K6 {ref_ms[0]:.3f} ms "
            f"= {ref_ms[0] / TRAIN_REF_STEPS:.5f} ms a step on the device, "
            f"bound {ref_bms:.3e} ms a step ({ref_by}), loss "
            f"{losses[0]:.2f} -> {losses[-1]:.2f}, launches {ref_counts}, "
            f"on {name}")
    return counts, {"ms": step_ms, "ms_per_launch": launch_ms,
                    "steps_per_s": RNVP_STEPS / dt, "bound_ms": bms,
                    "bound_by": by, "ref_ms": ref_ms[0] / TRAIN_REF_STEPS,
                    "ref_steps_per_s": TRAIN_REF_STEPS / dt_ref,
                    "ref_bound_ms": ref_bms, "ref_bound_by": ref_by}


def phase_graph_step(name):
    """One eager K4/K5 train step of the demo captured in a CUDA graph and
    replayed: the yardstick of K6. The capture is the profiler's
    (benchmarks/torch_profile.py), so both time the same graph."""
    import normalizingflows_torch as nft

    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks"))
    from torch_profile import capture_train_step

    flow = _rnvp(RNVP_DEMO, 0, True)
    reset_counts()
    graph, loss = capture_train_step(flow, nft.Banana(2, 1.0, 100.0),
                                     RNVP_BATCH, RNVP_LR, _warmup_stream())
    # the counters count at capture: 3 warm steps and the captured one
    expect_counts("phase 21, capture", coupling_fwd=4, coupling_bwd=4)
    reset_counts()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(GRAPH_STEPS):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_ms = start.elapsed_time(stop) / GRAPH_STEPS
    if not bool(torch.isfinite(loss)):
        raise AssertionError("the graphed step gave a non-finite loss")
    say(21, f"CUDA graph of one eager K4/K5 demo step, {GRAPH_STEPS} "
            f"replays: {GRAPH_STEPS / dt:.1f} steps/s, {step_ms:.5f} ms a "
            f"step on the device (CUDA events), last loss {float(loss):.4f},"
            f" on {name}")
    return {"graph_step_ms": step_ms, "graph_steps_per_s": GRAPH_STEPS / dt}


def selected_phases(argv=None) -> set:
    """The phases a command line asks for, with phase 1 and the phases
    whose results a selected one takes: 7 takes 5's flow, 15 takes 14's."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", type=parse_phases, default=ALL_PHASES,
                        help="phases to run, e.g. 1,2,12,18-21 (default: "
                             "all)")
    phases = set(parser.parse_args(argv).phases) | {1}
    phases |= {5} if 7 in phases else set()
    phases |= {14} if 15 in phases else set()
    return phases


def main(argv=None) -> int:
    phases = selected_phases(argv)
    t_start = time.perf_counter()
    smi = phase_device()
    import normalizingflows_torch  # noqa: F401  (fails outside a checkout)

    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    if 2 in phases:
        phase_build()
    if 3 in phases:
        kernels = phase_kernels(gen)
    if 4 in phases:
        phase_same_step(gen)
    if 5 in phases:
        flow, elbo_launches = phase_main_path(gen, name)
    if 6 in phases:
        phase_wide(gen, name)
    if 7 in phases:
        phase_round_trip(flow, gen)
    if 8 in phases:
        phase_loglikelihood(gen)
    if 9 in phases:
        phase_stl()
    if 10 in phases:
        mle_launches = phase_mle(gen, name)
    if 11 in phases:
        phase_mle_wide(gen, name)
    if 12 in phases:
        cpl = phase_coupling_kernels(gen)
    if 13 in phases:
        phase_rnvp_same_step(gen)
    rnvp_summary = None
    if 14 in phases:
        rnvp_flows, rnvp_launches, rnvp_summary = phase_rnvp_main(name)
    if 15 in phases:
        phase_rnvp_sampling(rnvp_flows, gen, name)
    if 16 in phases:
        phase_rnvp_ref(gen, name)
    if 17 in phases:
        phase_rnvp_wide(gen, name)
    if 18 in phases:
        train = phase_train_kernel(gen)
    if 19 in phases:
        phase_train_vs_eager(gen)
    if 20 in phases:
        train_launches, train_main = phase_train_main(name, rnvp_summary)
    if 21 in phases:
        graph = phase_graph_step(name)
    torch.cuda.synchronize()
    device_line = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}})
    if phases != set(ALL_PHASES):
        print(f"chip_smoke.py: phases {sorted(phases)} passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        print(f"card: {smi}", flush=True)
        print(device_line, flush=True)
        return 0
    train.update(train_main, **graph,
                 eager_step_ms=1e3 / rnvp_summary["steady"])

    # each kernel's launches on the path it serves: K2 on the ELBO path,
    # K1 and K3 on the density path (K1 runs on both), K4 and K5 on the
    # RealNVP demo's, K6 on the demo's whole-run training
    paths = {"elbo_demo": elbo_launches, "mle_demo": mle_launches,
             "realnvp_demo": rnvp_launches,
             "realnvp_train_demo": train_launches}
    own = {"rqs_fwd": "mle_demo", "rqs_bwd_fwddir": "elbo_demo",
           "rqs_bwd_invdir": "mle_demo", "coupling_fwd": "realnvp_demo",
           "coupling_bwd": "realnvp_demo",
           "realnvp_train": "realnvp_train_demo"}

    def entry(k, source, r, extra):
        return {"name": k, "route": "cuda",
                "source": f"normalizingflows_torch/csrc/{source}",
                "replaces": REPLACES[k], "launches": paths[own[k]][k],
                "launches_by_path": {p: c[k] for p, c in paths.items()},
                "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                **{key: r[key] for key in extra}}

    print(f"chip_smoke.py: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": [
        entry(k, "rqs.cu", kernels[k],
              ("ms_demo", "plain_ms_demo", "bound_ms_demo"))
        for k in KERNELS] + [
        entry(k, "coupling.cu", cpl[k],
              ("unfused_ms", "ms_by_n", "plain_ms_by_n", "bound_ms_by_n",
               "unfused_ms_by_n"))
        for k in CPL_KERNELS] + [
        entry("realnvp_train", "train.cu", train,
              ("ms_per_launch", "steps_per_s", "graph_step_ms",
               "graph_steps_per_s", "eager_step_ms", "ref_ms",
               "ref_steps_per_s", "ref_bound_ms", "ref_bound_by"))]}),
          flush=True)
    print(device_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
