#!/usr/bin/env python3
"""The spread of `chip_smoke.py` phase 47's and phase 52's gates over many
draws, on the card:

    python benchmarks/torch_leaf_scan.py [--seeds 256] [--seed0 0]
        [--n 262144] [--forward-only] [--package DIR] [--out FILE]
    python benchmarks/torch_leaf_scan.py --k6 [--seeds 64] [--out FILE]
    python benchmarks/torch_leaf_scan.py --take-apart SEED [--inverse]
        [--rows 4096] [--package DIR] [--out FILE]
    python benchmarks/torch_leaf_scan.py --merge FILE... [--out FILE]

By default (K5), for each seed the demo's perturbed seed-30 stack (d=2,
[16,16]x3) under the bf16 policy at N rows, forward and inverse, on
`chip_smoke._policy_draws` from a generator of that seed (phase 47's demo
case at that N, `chip_smoke.policy_draw_reading`): the kernels' relative
L2 error from the plain version in each output (y, ld, gx, every weight
gradient) over the float64-summed witness's (`_dot_witness`, the same
roundings in another order), the ratio phase 47 holds to
DEEP_WITNESS_FACTOR (`witness_gate`), and the same ratio for each faulty
control (`WITNESS_CONTROLS`), which the gate must catch; and, as a
reading, each weight gradient's error over the float32 K5's against the
float32 plain version (`chip_smoke._leaf_ratio`), the kernels' and the
witness's, and the share of rows whose y, ld and gx are the witness's bit
for bit; and the spans of the kernels' float64 products (`_spans`): of
every product K4 takes and every product K5 sums on the float64 tensor
cores, on the witness's operands, how many span more than 53 bits (the
one place where the float64 mma's sum can round), and the widest. Prints
one JSON object (and writes it to ``--out``): the quantiles of each ratio
(the largest a draw), the draws the gate fails, the draws a control
passes and the spans' totals. ``--package DIR`` runs another
checkout's package (its kernels, built into its own ``build/``) under
this checkout's gates, for example the parent commit unpacked with
``git archive``.

``--k6``: K6 (`train_cuda.adam_train_realnvp_fused`) in float32, 25 Adam
steps, on Banana, Funnel and WarpedGauss at the demo (batch 16) and the
reference default (batch 256), each on draws from a generator of each
seed (`chip_smoke._train_args`, flow seed 52 as phase 52): each output's
relative L2 error against the float64 plain run over the larger of two
correct float32 runs' (the plain version, and the plain version on the
batch's rows shuffled), the ratio phase 52 holds to
K6_WITNESS_FACTOR (`k6_witness_gate`), beside the float32 plain version's
alone (the old gate's) and the faulty control's
(`chip_smoke._k6_bf16_products`); and whether phase 52's gate, which takes
outputs with elements outside TRAIN_TOL, passes the kernel and fails the
control. Beside it the check before Adam amplifies roundoff
(`k6_first_gate`): the first loss and K6's first moment after one step
(`k6_first_step`) on the first batch drawn off the kinks
(`k6_first_args`, the rows drawn again counted) against the float64 plain
run's, the ratio phase 52 holds to K6_FIRST_FACTOR, K6's and the faulty
control's.

``--take-apart SEED`` takes one draw's worst weight gradient apart
(`take_apart`): the kernel's sum of it per CTA slice (before
``coupling_bwd_reduce``) and per 16-row tile, beside the exact sums of
the plain version's and the witness's own terms over the same rows; over
the first ``--rows`` rows, and the rows of the tiles that differ most,
the kernel's own terms (one launch a row), so that a tile's excess splits
into its terms' and its sum's; and for the row whose terms differ most,
its nearest leaky-ReLU pre-activation to 0. ``--merge`` sums up scans
of one kind run over disjoint seeds (``--seed0``, ``--seeds``), for
example in processes side by side on one card. Needs a CUDA device,
but for ``--merge``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
cs = cc = None  # chip_smoke and coupling_cuda, bound by `_load`


def _load(package):
    """This checkout's chip_smoke.py, with the port's package imported from
    ``package`` (another checkout's root; None: this one)."""
    global cs, cc
    sys.path.insert(0, str(package or HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    from normalizingflows_torch.experimental import coupling_cuda
    cc = coupling_cuda
    root = Path(cc.__file__).resolve().parents[2]
    if root != Path(package or HERE).resolve():
        raise RuntimeError(f"imported {cc.__file__}, not {package}'s")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _quantiles(values) -> dict:
    v = sorted(values)
    return {f"q{q}": v[min(len(v) - 1, int(q / 100 * len(v)))]
            for q in (50, 90, 99)} | {"max": v[-1]}


def _lsb(v):
    """The exponent of each bfloat16 value's lowest set bit (int32; 2^20
    where it is zero): v = M·2^(E − 134) with M = 128 + its mantissa where
    its exponent field E is past 0, else M = its mantissa and E = 1."""
    u = v.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    e, m = (u >> 7) & 0xFF, u & 0x7F
    sig = torch.where(e > 0, m | 0x80, m)
    base = torch.where(e > 0, e - 134, torch.full_like(e, -133))
    tz = torch.log2((sig & -sig).clamp(min=1).float()).round().int()
    return torch.where(sig > 0, base + tz, torch.full_like(e, 1 << 20))


def _product_spans(a, b, rows=32768):
    """`chip_smoke.dmma_span` of every product a[r]·b[:, o] (from zero) of
    bfloat16 a (n, k) and b (k, m): (n, m) int32, 0 where every term is
    zero. The top is taken from the float64 sum of the terms' magnitudes,
    which may round up to the next power of two only where the exact sum
    spans past 53 bits, so a span is never under the exact one."""
    la, lb = _lsb(a), _lsb(b)
    out = []
    for r0 in range(0, a.shape[0], rows):
        low = (la[r0:r0 + rows, :, None] + lb[None]).amin(1)
        top = a[r0:r0 + rows].abs().double() @ b.abs().double()
        hi = torch.frexp(top).exponent - 1
        out.append(torch.where(top > 0, hi - low + 1,
                               torch.zeros_like(low)))
    return torch.cat(out)


def _spans(n, seed, inverse, check=False) -> dict:
    """Of phase 47's demo draw at N = n from ``seed`` (the draw
    `chip_smoke.policy_draw_reading` reads), by kernel: the float64
    products (a row's output of one layer, head or input cotangent; K5's
    recomputed forward with its cotangents), on the operands of the
    float64-summed witness, which are the kernels' where they give the
    witness's bits; how many span more than 53 bits; and the widest span.
    ``check``: a few spans of each call held to `chip_smoke.dmma_span`."""
    fb = cs._bf16_fused(cs.RNVP_DEMO, "f32_cbf16")
    cd = cs.CPL_BF16_VARIANTS["f32_cbf16"][1]
    sels = cc._sels(fb.idx_even, fb.idx_odd, cs.RNVP_DEMO["q0"])
    gen = torch.Generator(device=cs.DEVICE).manual_seed(seed)
    x, gy, gld, _ = cs._policy_draws(cc, fb, sels, n, "f32_cbf16", gen)
    out, real = {}, cc._dot

    def rec(kernel):
        tally = out.setdefault(kernel, {"products": 0, "past_53": 0,
                                        "max_span": 0})

        def dot(a, b, c=None):
            # K5's weight gradients (in, n)·(n, out) run on the bfloat16
            # tensor cores: not counted
            if not (a.shape[-1] == n and b.shape[0] == n):
                a16, b16 = a.detach().to(cd), b.detach().to(cd)
                s = _product_spans(a16, b16)
                tally["products"] += s.numel()
                tally["past_53"] += int((s > 53).sum())
                tally["max_span"] = max(tally["max_span"], int(s.max()))
                if check:
                    for r, o in zip(*(torch.randint(0, m, (4,)).tolist()
                                      for m in s.shape)):
                        want = cs.dmma_span(a16[r].double().tolist(),
                                            b16[:, o].double().tolist(), 0.0)
                        got = int(s[r, o])
                        assert got == want or (want > 53 and got >= want), (
                            kernel, got, want)
            return cs._dot_witness(a, b, c)
        return dot

    try:
        cc._dot = rec("K4")
        cc.tile_flow(x, fb.groups, sels, inverse, cd)
        cc._dot = rec("K5")
        cc.tile_flow_bwd(x, fb.groups, gy, gld, sels, inverse, cd)
    finally:
        cc._dot = real
    return out


def k5_draw(n, seed, inverse, check=False) -> dict:
    """One draw of phase 47's demo case under its gate."""
    r = cs.policy_draw_reading(cc, n, seed, inverse)
    floor = cs.LEAF_FLOOR

    def top(errs):
        return max(e / max(ew, floor) for e, ew in errs)

    mine = [(e, ew) for _, e, ew in r["mine"]]
    worst = max(r["mine"], key=lambda m: m[1] / max(m[2], floor))
    return dict(
        seed=seed, inverse=inverse, ratio=top(mine), worst_output=worst[0],
        gate=all(cs.witness_gate(e, ew) for e, ew in mine),
        controls={k: top(v) for k, v in r["controls"].items()},
        controls_caught={k: not all(cs.witness_gate(e, ew) for e, ew in v)
                         for k, v in r["controls"].items()},
        leaf_ratio=max(e / max(e32, floor) for e, e32, _ in r["leaves"]),
        leaf_witness_ratio=max(ew / max(e32, floor)
                               for _, e32, ew in r["leaves"]),
        witness_rows=r["witness_rows"],
        spans=_spans(n, seed, inverse, check))


def k5_scan(n, seeds, seed0, directions) -> dict:
    return k5_summary([k5_draw(n, seed, inverse, check=seed == seed0)
                       for seed in range(seed0, seed0 + seeds)
                       for inverse in directions], n)


def k5_summary(draws, n) -> dict:
    q = {}
    for dr in sorted({d["inverse"] for d in draws}):
        mine = [d for d in draws if d["inverse"] == dr]
        key = "inverse" if dr else "forward"
        q[key] = dict(
            kernel=_quantiles([d["ratio"] for d in mine]),
            controls={k: _quantiles([d["controls"][k] for d in mine])
                      for k in cs.WITNESS_CONTROLS},
            leaf_kernel=_quantiles([d["leaf_ratio"] for d in mine]),
            leaf_witness=_quantiles([d["leaf_witness_ratio"] for d in mine]),
            witness_rows_least=min(d["witness_rows"] for d in mine))
    seeds = sorted({d["seed"] for d in draws})
    return dict(
        kind="k5", n=n, seeds=[seeds[0], seeds[-1]], draws=len(draws),
        factor=cs.DEEP_WITNESS_FACTOR, quantiles=q,
        gate_fails=[d for d in draws if not d["gate"]],
        controls_missed=[d for d in draws
                         if not all(d["controls_caught"].values())],
        controls_least={k: min(d["controls"][k] for d in draws)
                        for k in cs.WITNESS_CONTROLS},
        spans={k: {"products": sum(d["spans"][k]["products"] for d in draws),
                   "past_53": sum(d["spans"][k]["past_53"] for d in draws),
                   "max_span": max(d["spans"][k]["max_span"]
                                   for d in draws)}
               for k in ("K4", "K5") if all("spans" in d for d in draws)},
        worst=sorted(draws, key=lambda d: -d["ratio"])[:8], each=draws)


K6_MODELS = (("demo", 16), ("ref", 256))
K6_TARGETS = ("banana", "funnel", "warped")


def k6_draw(model, batch, kind, seed) -> dict:
    """One K6 draw under phase 52's gate (`chip_smoke._k6_against_plain`'s
    float32 witness)."""
    from normalizingflows_torch.experimental import train_cuda as tc

    floor = cs.LEAF_FLOOR
    gen = torch.Generator(device=cs.DEVICE).manual_seed(seed)
    _, args = cs._train_args(cs.CPL_CFG[model], torch.float32, batch,
                             cs.TRAIN_CMP_STEPS, 52, gen, target=kind)
    got = cs._train_outputs(tc.adam_train_realnvp_fused(*args,
                                                        backend="cuda"))
    errs, want = cs.k6_witness_reading(got, args)
    fargs = cs.k6_first_args(args)
    first = cs.k6_first_reading(cs.k6_first_step(fargs), fargs)
    kink_rows = int((fargs[0][0] != args[0][0]).any(1).sum())
    f_floor = cs.K6_FIRST_FLOOR
    tol = cs.TRAIN_TOL[torch.float32]
    outside = [bool(((a.double() - b.double()).abs()
                     > tol[1] + tol[0] * b.double().abs()).any())
               for a, b in zip(got + [got[0][:1]], want + [want[0][:1]])]
    return dict(
        model=model, batch=batch, target=kind, seed=seed,
        ratio=max(e / max(e32, er, floor) for e, e32, er, _ in errs),
        ratio_plain_only=max(e / max(e32, floor) for e, e32, _, _ in errs),
        shuffled_ratio=max(er / max(e32, floor) for _, e32, er, _ in errs),
        control=max(ec / max(e32, er, floor) for _, e32, er, ec in errs),
        gate=all(cs.k6_witness_gate(e, e32, er) or not o
                 for (e, e32, er, _), o in zip(errs, outside)),
        control_caught=not all(cs.k6_witness_gate(ec, e32, er)
                               for _, e32, er, ec in errs),
        control_first_loss=errs[-1][3] / max(errs[-1][1], errs[-1][2],
                                             floor),
        outputs_outside_tol=sum(outside),
        first_ratio=max(e / max(e32, er, f_floor) for e, e32, er, _ in first),
        first_control=max(ec / max(e32, er, f_floor)
                          for _, e32, er, ec in first),
        first_gate=all(cs.k6_first_gate(e, e32, er)
                       for e, e32, er, _ in first),
        first_control_caught=not all(cs.k6_first_gate(ec, e32, er)
                                     for _, e32, er, ec in first),
        first_kink_rows=kink_rows,
        errors=errs, first_errors=first)


def k6_scan(seeds, seed0) -> dict:
    return k6_summary([k6_draw(model, batch, kind, seed)
                       for model, batch in K6_MODELS for kind in K6_TARGETS
                       for seed in range(seed0, seed0 + seeds)])


def k6_summary(draws) -> dict:
    q = {}
    for model, kind in dict.fromkeys((d["model"], d["target"])
                                     for d in draws):
        mine = [d for d in draws
                if d["model"] == model and d["target"] == kind]
        q[f"{model}_{kind}"] = {
            k: _quantiles([d[k] for d in mine])
            for k in ("ratio", "ratio_plain_only", "shuffled_ratio",
                      "control", "control_first_loss", "first_ratio",
                      "first_control")}
    seeds = sorted({d["seed"] for d in draws})
    return dict(
        kind="k6", seeds=[seeds[0], seeds[-1]], draws=len(draws),
        factor=cs.K6_WITNESS_FACTOR, quantiles=q,
        all_ratio=_quantiles([d["ratio"] for d in draws]),
        gate_fails=[d for d in draws if not d["gate"]],
        controls_missed=[d for d in draws if not d["control_caught"]],
        control_least=min(d["control"] for d in draws),
        control_first_loss_least=min(d["control_first_loss"] for d in draws),
        first_factor=cs.K6_FIRST_FACTOR, first_floor=cs.K6_FIRST_FLOOR,
        first_ratio=_quantiles([d["first_ratio"] for d in draws]),
        first_control_least=min(d["first_control"] for d in draws),
        first_gate_fails=[d for d in draws if not d["first_gate"]],
        first_controls_missed=[d for d in draws
                               if not d["first_control_caught"]],
        worst=sorted(draws, key=lambda d: -d["ratio"])[:8], each=draws)


def _gw_operands(dot, fb, x, gy, gld, sels, inverse, cd):
    """The operands of every weight-gradient product of the plain version
    (`coupling_cuda._dot` replaced by ``dot``; None: as it is), rounded to
    the policy's bfloat16 as `_dot` rounds them, by (leaf, block): (a
    (in, n), b (n, out)); for the bias gradient beside it (leaf + 1), the
    cotangent's sum over the rows, (ones (1, n), b unrounded)."""
    depth = len(fb.groups["even"]["s"])
    calls, real = [], cc._dot
    base = dot or real
    n = x.shape[0]

    def rec(a, b, c=None):
        if a.dim() == 2 and a.shape[1] == n and b.shape[0] == n:
            calls.append((a.detach().to(cd), b.detach()))
        return base(a, b, c)

    cc._dot = rec
    try:
        cc.tile_flow_bwd(x, fb.groups, gy, gld, sels, inverse, cd)
    finally:
        cc._dot = real
    out, it = {}, iter(calls)
    for (bi, grp, *_rest) in cc._couplings(fb.groups, sels, inverse)[::-1]:
        for ni in range(2):
            for li in range(depth - 1, -1, -1):
                leaf = ((cc._GROUPS.index(grp) * 2 + ni) * depth + li) * 2
                a, b = next(it)
                out[(leaf, bi)] = (a, b.to(cd))
                out[(leaf + 1, bi)] = (b.new_ones((1, n)), b)
    return out


def _per_tile(ops, leaf, blocks, rows):
    """Exact (float64) sums of one leaf's terms a[:, r]·b[r, :] over each
    ``rows``-row tile: (tiles, blocks, in, out)."""
    sums = []
    for bi in range(blocks):
        a, b = (t.double() for t in ops[(leaf, bi)])
        tiles = a.shape[1] // rows
        sums.append(torch.einsum("itk,tko->tio",
                                 a[:, :tiles * rows].reshape(-1, tiles, rows),
                                 b[:tiles * rows].reshape(tiles, rows, -1)))
    return torch.stack(sums, dim=1)


def _terms(ops, leaf, blocks, rows):
    """One leaf's exact terms a[:, r]·b[r, :] at the rows ``rows``:
    (rows, blocks, in, out)."""
    idx = torch.as_tensor(list(rows), device=ops[(leaf, 0)][0].device)
    return torch.stack([
        torch.einsum("ir,ro->rio", ops[(leaf, bi)][0].double()[:, idx],
                     ops[(leaf, bi)][1].double()[idx])
        for bi in range(blocks)], dim=1)


def _nearest_kink(x, groups, sels, cd, inverse):
    """The leaky-ReLU pre-activation nearest 0 on row x (1, d), in float64
    on the operands the policy rounds (as `chip_smoke._kink_rows` reads
    them): (|z|, coupling, net, layer, unit)."""
    def rnd(v):
        return v.to(cd).double()

    g64 = {grp: {net: [(layer[0].double(), layer[1].double())
                       for layer in groups[grp][net]] for net in ("s", "t")}
           for grp in ("even", "odd")}
    best = (math.inf,)
    h_x, ld = x.double(), x.new_zeros(1, dtype=torch.float64)
    for c, (_, _, idx_a, idx_b, s_w, t_w) in enumerate(
            cc._couplings(g64, sels, inverse)):
        for ni, net in enumerate((s_w, t_w)):
            h = cc._pick(h_x, idx_b)
            for li, (W, b) in enumerate(net[:-1]):
                z = rnd(h) @ rnd(W) + b
                a = z.abs()[0]
                k = int(a.argmin())
                if float(a[k]) < best[0]:
                    best = (float(a[k]), c, "st"[ni], li, k)
                h = cc._leaky_relu(z)
        h_x, ld = cc._apply_coupling(h_x, ld, idx_a, idx_b, s_w, t_w,
                                     inverse, cd)
    return dict(zip(("abs_z", "coupling", "net", "layer", "unit"), best))


def _k5_slices(x, leaves, gy, gld, sels, depth, inverse, cd):
    """The policy's K5 as `coupling_cuda._launch_bwd` runs it, keeping the
    CTAs' partial slices: (weight gradients, slices (CTAs, n_params), rows
    a CTA's tile)."""
    from normalizingflows_torch.ops._build import library

    sfx, widths, idx = cc._kernel_args(x, leaves, sels, depth, backward=True,
                                       compute_dtype=cd)
    n, d = x.shape
    rows = cc.mma_plan(d, leaves[0].shape[0], depth, widths, True).rows
    n_ctas = min(-(-n // rows), cc.BWD_MAX_CTAS)
    scratch = torch.full((n_ctas, sum(t.numel() for t in leaves)), math.nan,
                         device=x.device)
    gx = torch.empty_like(x)
    grads = [torch.empty_like(t) for t in leaves]
    err = getattr(library(), f"coupling_bwd_{sfx}")(
        x.data_ptr(), gy.data_ptr(), gld.data_ptr(), gx.data_ptr(),
        scratch.data_ptr(), n, d, leaves[0].shape[0], depth, widths, idx,
        cc._pointers(leaves), cc._pointers(grads), n_ctas, int(inverse),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"coupling_bwd_{sfx}: CUDA error {err}")
    used = int((~scratch.isnan().any(dim=1)).sum())
    return grads, scratch[:used], rows


def _spread(diff, total_dir) -> dict:
    """How a signed sum of per-tile differences ``diff`` (tiles, k) builds
    up: its total, the mean's z-score over the tiles (a coherent bias is
    large, roundoff about 1), and the share of the total, projected on
    ``total_dir``, that the top 1 % and 10 % of tiles carry."""
    diff = diff.reshape(diff.shape[0], -1).double()
    tiles = diff.shape[0]
    proj = diff @ total_dir
    total = float(proj.sum())
    mean, std = float(proj.mean()), float(proj.std())
    order = proj.abs().sort(descending=True).values
    top = {f"top{p}pct_share": float(order[:max(1, tiles * p // 100)].sum())
           / max(abs(total), 1e-300) for p in (1, 10)}
    return dict(tiles=tiles, total=total,
                bias_z=mean / (std / math.sqrt(tiles)) if std else 0.0,
                norm=float(diff.sum(0).norm()), **top)


def take_apart(seed: int, inverse: bool, n: int, sub_rows: int) -> dict:
    """One draw of phase 47's demo case (`chip_smoke.policy_leaf_reading`)
    taken apart at its worst weight gradient: the kernel's sum per CTA
    slice and per 16-row tile against the exact sums of the plain
    version's and of the witness's terms over the same rows; over the
    first ``sub_rows`` rows the kernel's own terms (a launch a row: its
    sum over one row is the term: a product of two bfloat16 values, exact)
    against the plain version's, and each tile's sum against the exact sum
    of its own terms; the same for the three tiles that differ most, with
    the nearest kink of their worst row."""
    fb = cs._bf16_fused(cs.RNVP_DEMO, "f32_cbf16")
    cd = cs.CPL_BF16_VARIANTS["f32_cbf16"][1]
    d, depth = cs.RNVP_DEMO["q0"], len(cs.RNVP_DEMO["hdims"]) + 1
    sels = cc._sels(fb.idx_even, fb.idx_odd, d)
    leaves = [t.detach() for t in cc._leaves(fb.groups)]
    blocks = leaves[0].shape[0]
    gen = torch.Generator(device=cs.DEVICE).manual_seed(seed)
    x, gy, gld, _ = cs._policy_draws(cc, fb, sels, n, "f32_cbf16", gen)
    grads, slices, cta_rows = _k5_slices(x, leaves, gy, gld, sels, depth,
                                         inverse, cd)
    wants = cc._leaves(cc.tile_flow_bwd(x, fb.groups, gy, gld, sels,
                                        inverse, cd)[1])
    witness = cs._plain_on(cc, cs._dot_witness, fb, x, gy, gld, sels,
                           inverse, cd)[3:]
    errs = cs._leaf_errors(cc, fb, x, gy, gld, sels, inverse, grads, wants)
    err_w = [cs._rel([w], [b]) for w, b in zip(witness, wants)]
    leaf = max(range(len(leaves)),
               key=lambda i: errs[i][0] / max(err_w[i], cs.LEAF_FLOOR))
    e, e32 = errs[leaf]
    ew = err_w[leaf]
    # (blocks, in, out); a bias gradient's (blocks, 1, out)
    shape = leaves[leaf].shape if leaf % 2 == 0 else (
        blocks, 1, leaves[leaf].shape[-1])
    off = sum(t.numel() for t in leaves[:leaf])
    got = grads[leaf].double().reshape(shape)
    want = wants[leaf].double().reshape(shape)
    total_dir = (got - want).reshape(-1)
    if not total_dir.any():
        total_dir = torch.ones_like(total_dir)
    total_dir = total_dir / total_dir.norm()
    plain_ops = _gw_operands(None, fb, x, gy, gld, sels, inverse, cd)
    wit_ops = _gw_operands(cs._dot_witness, fb, x, gy, gld, sels, inverse,
                           cd)
    res = dict(seed=seed, inverse=inverse, n=n, leaf=leaf,
               shape=list(shape), kernel_err=e, f32_err=e32,
               witness_err=ew, ratio=e / max(e32, cs.LEAF_FLOOR),
               witness_ratio=ew / max(e32, cs.LEAF_FLOOR),
               to_witness=e / max(ew, cs.LEAF_FLOOR))
    # per 16-row tile: a launch a tile, whose sum is the kernel's partial
    # of that warp tile (its k16 product from zero, the other warps' zero
    # rows adding exactly 0)
    tiles = n // 16
    ker = torch.empty((tiles,) + tuple(shape), dtype=torch.float64,
                      device=x.device)
    for t in range(tiles):
        r = slice(16 * t, 16 * t + 16)
        ker[t] = cc._launch_bwd(x[r].contiguous(), leaves,
                                gy[r].contiguous(), gld[r].contiguous(),
                                sels, depth, inverse,
                                cd)[1][leaf].double().reshape(shape)
    plain_t = _per_tile(plain_ops, leaf, blocks, 16)
    wit_t = _per_tile(wit_ops, leaf, blocks, 16)
    # the tiles that differ most: their rows' terms, a launch a row, and
    # the row that differs most
    dk = (ker - plain_t).reshape(tiles, -1).norm(dim=1)
    dw = (wit_t - plain_t).reshape(tiles, -1).norm(dim=1)
    res["top_tiles"] = []
    for tt in dk.argsort(descending=True)[:3].tolist():
        rows = range(16 * tt, 16 * tt + 16)
        kt = torch.stack([cc._launch_bwd(
            x[r:r + 1].contiguous(), leaves, gy[r:r + 1].contiguous(),
            gld[r:r + 1].contiguous(), sels, depth, inverse,
            cd)[1][leaf].double().reshape(shape) for r in rows])
        pt, wt = (_terms(ops, leaf, blocks, rows)
                  for ops in (plain_ops, wit_ops))
        row_d = (kt - pt).reshape(16, -1).norm(dim=1)
        worst = int(row_d.argmax())
        r = rows[worst]
        y_k, ld_k = cc._launch_fwd(x[r:r + 1].contiguous(), leaves, sels,
                                   depth, inverse, compute_dtype=cd)
        y_p, ld_p = cc.tile_flow(x[r:r + 1], fb.groups, sels, inverse, cd)
        res["top_tiles"].append(dict(
            tile=tt, diff_norm=float(dk[tt]), witness_diff_norm=float(dw[tt]),
            own_terms_sum=float((kt.sum(0) - ker[tt]).norm()),
            row=r, row_diff=float(row_d[worst]),
            row_witness_diff=float((wt - pt).reshape(16, -1)
                                   .norm(dim=1)[worst]),
            row_terms=float(pt[worst].norm()),
            rows_moved=int((row_d > 1e-3 * float(row_d.max())).sum()),
            x=x[r].tolist(), y_diff=float((y_k - y_p).abs().max()),
            ld_diff=float((ld_k - ld_p).abs().max()),
            kink=_nearest_kink(x[r:r + 1], fb.groups, sels, cd, inverse)))
    res["tiles16"] = dict(
        kernel=_spread(ker - plain_t, total_dir),
        witness=_spread(wit_t - plain_t, total_dir),
        kernel_sum_vs_final=float((ker.sum(0) - got).norm() / want.norm()),
        plain_terms_vs_plain=float((plain_t.sum(0) - want).norm()
                                   / want.norm()))
    # per CTA slice (the CTA's tiles of cta_rows rows, c, c + G, ...)
    G = slices.shape[0]
    sl = slices[:, off:off + got.numel()].double().reshape((G,) + tuple(shape))
    per_cta = cta_rows // 16

    def by_cta(per16):
        t64 = per16[:tiles - tiles % per_cta].reshape(
            -1, per_cta, *per16.shape[1:]).sum(1)
        return torch.stack([t64[c::G].sum(0) for c in range(G)])

    res["ctas"] = dict(
        ctas=G, rows=cta_rows,
        kernel=_spread(sl - by_cta(plain_t), total_dir),
        witness=_spread(by_cta(wit_t) - by_cta(plain_t), total_dir),
        tiles_vs_slices=float((by_cta(ker) - sl).norm() / want.norm()))
    # the first sub_rows rows: the kernel's terms, a launch a row
    sub = min(sub_rows, n) // 16 * 16
    terms = torch.empty((sub,) + tuple(shape), dtype=torch.float64,
                        device=x.device)
    for r in range(sub):
        terms[r] = cc._launch_bwd(x[r:r + 1].contiguous(), leaves,
                                  gy[r:r + 1].contiguous(),
                                  gld[r:r + 1].contiguous(), sels, depth,
                                  inverse,
                                  cd)[1][leaf].double().reshape(shape)
    plain_terms = _per_tile(plain_ops, leaf, blocks, 1)[:sub]
    wit_terms = _per_tile(wit_ops, leaf, blocks, 1)[:sub]
    scale = plain_terms.abs().amax()

    def flips(a, b):
        dd = (a - b).reshape(sub, -1)
        moved = dd.abs() > 2 ** -20 * scale
        return dict(moved=int(moved.sum()), up=int((dd > 2 ** -20 * scale)
                                                    .sum()),
                    signed_sum=float(dd.sum()), abs_sum=float(dd.abs().sum()))

    res["rows"] = dict(
        rows=sub, kernel_terms=flips(terms, plain_terms),
        witness_terms=flips(wit_terms, plain_terms),
        kernel_terms_spread=_spread(
            (terms - plain_terms).reshape(sub // 16, 16, -1).sum(1),
            total_dir),
        kernel_sum_spread=_spread(
            ker[:sub // 16] - terms.reshape(sub // 16, 16,
                                            *shape).sum(1), total_dir))
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=None,
                        help="draws a case (default 256, --k6 64)")
    parser.add_argument("--seed0", type=int, default=0)
    parser.add_argument("--n", type=int, default=262144)
    parser.add_argument("--forward-only", action="store_true")
    parser.add_argument("--k6", action="store_true",
                        help="scan phase 52's K6 gate instead")
    parser.add_argument("--package", type=Path,
                        help="the port's package from this checkout")
    parser.add_argument("--out", help="also write the JSON here")
    parser.add_argument("--take-apart", type=int, metavar="SEED",
                        help="take this seed's draw apart instead")
    parser.add_argument("--inverse", action="store_true")
    parser.add_argument("--rows", type=int, default=4096,
                        help="rows whose terms --take-apart reads")
    parser.add_argument("--merge", nargs="+", type=Path, metavar="FILE",
                        help="merge the draws of scans over disjoint seeds")
    args = parser.parse_args()
    if args.merge:  # no device needed
        _load(None)
        parts = [json.loads(f.read_text()) for f in args.merge]
        draws = [d for part in parts for d in part["each"]]
        result = (k6_summary(draws) if parts[0]["kind"] == "k6"
                  else k5_summary(draws, parts[0]["n"]))
        result.update(card=parts[0]["card"], package=parts[0]["package"],
                      seconds=sum(part["seconds"] for part in parts),
                      merged=[str(f) for f in args.merge])
        text = json.dumps(result, indent=1)
        print(text)
        if args.out:
            Path(args.out).write_text(text)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    _load(args.package)
    t0 = time.perf_counter()
    if args.take_apart is not None:
        result = take_apart(args.take_apart, args.inverse, args.n,
                            args.rows)
    elif args.k6:
        result = k6_scan(args.seeds or 64, args.seed0)
    else:
        result = k5_scan(args.n, args.seeds or 256, args.seed0,
                         (False,) if args.forward_only else (False, True))
    result.update(card=_card(), package=str(args.package or HERE),
                  seconds=time.perf_counter() - t0)
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
