"""K1–K6 of two checkouts of this repository on one GPU, in turns.

    python benchmarks/torch_ab.py --parent DIR [--out FILE]

DIR is another checkout (for example the parent commit, unpacked with
``git archive``). Four runs, in the order DIR, this checkout, this
checkout, DIR, each a process of its own that imports the package and
``chip_smoke.py`` of its checkout (so each builds its own kernels into its
own ``build/``), on fixed seeds:

* K4 and K5 (``coupling_cuda._launch_fwd`` / ``_launch_bwd``) on the
  perturbed demo at N 16 and 300, the reference default at N 256 and d=5
  [8,8]x2 at N 300, float32 and float64, forward and inverse: y, ld, gx
  and every weight gradient, kept for a bitwise comparison across runs;
* device times (``chip_smoke.device_ms``: CUDA-graph replay between CUDA
  events) of K4 and K5 in float32 at demo N 16, reference N 256 and demo
  N 262,144, and of K4 at the demo's last N on this checkout's K4 lane
  tile and one past it (``--k4-n``, from this checkout's
  ``coupling_cuda``: the same N for both trees);
* K4 and K5 under the bf16 ``compute_dtype`` policy (``_f32_cbf16``): their
  outputs at the shapes above in both directions, kept for the bitwise
  comparison, and their device times at demo N 16, reference N 256 and
  demo N 262,144;
* the same policy times (two runs in one process) at 1, 2, 4 and 8 warps
  a CTA: this checkout's package and ``chip_smoke.py`` copied to
  ``build/torch_ab/warps<w>/`` with ``kMmaWarps`` set to w in the copy's
  ``csrc/coupling_mma.cuh`` (the tensor-core kernels' one constant for
  it), each copy built and run in a process of its own, after the four
  runs;
* the registers and spill bytes ptxas reports for every kernel of the
  checkout's build, so that the two trees' instantiations can be held
  against each other;
* K6 (``train_cuda.adam_train_realnvp_fused``, launches of 512 steps): the
  demo (1,000 steps, batch 16) and the reference default (50 steps, batch
  256) from their seed-0 flows, float32 and float64: the losses and every
  final weight, kept for the bitwise comparison;
* K6 through ``train_realnvp_fused``: the same two runs in float32, device
  time a step by CUDA events around each launch
  (``chip_smoke._timed_train``), and steps/s;
* K1, K2 and K3 through autograd of ``rqs_cuda.rqs_fused`` (elem-major raw
  as the conditioner's (batch, n_t·(3K−1)) output viewed per element),
  ``rqs_fused_e`` (raw padded to 3K+2 columns) and ``rqs_fused_t``
  (param-major raw): y, ld, gx and graw at float32 and float64, K 8 and
  10, N 64, 256, 257, 1,000 and 131,072, both directions, kept as SHA-256
  digests of their bytes (the tensors would fill gigabytes);
* device times of K1 (both directions), K2 and K3 (``rqs_cuda._launch_fwd``
  / ``_launch_bwd``) in float32 at K=10, N 64, 256 and 131,072 (the last
  in the wide layout, n_t = 32), warm, and at 131,072 also with a cold L2
  (a 64 MiB buffer written before each call, its own time subtracted).

Prints one JSON object (and writes it to ``--out``): the card, each run's
times, and per output whether DIR and this checkout gave identical bits
and whether this checkout's two runs did. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
SHAPES = (("demo", 16), ("demo", 300), ("ref", 256), ("odd", 300))
RQS_N, RQS_TIMED = (64, 256, 257, 1000, 131072), (64, 256, 131072)
WIDE_N = 131072


def _outputs(cs, cc) -> dict:
    """K4's and K5's outputs at SHAPES, float32 and float64, both
    directions, on the CPU."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        for model, n in SHAPES:
            cfg = cs.CPL_CFG[model]
            fb = cs._perturbed(cs._rnvp(cfg, 30, True, dtype)).bijector \
                .bijectors[0]
            d, depth = cfg["q0"], len(cfg["hdims"]) + 1
            gen = torch.Generator(device="cuda").manual_seed(n)
            x = torch.randn((n, d), generator=gen, device="cuda", dtype=dtype)
            gy = torch.randn((n, d), generator=gen, device="cuda",
                             dtype=dtype) / n
            gld = torch.randn((n,), generator=gen, device="cuda",
                              dtype=dtype) / n
            sels = cc._sels(fb.idx_even, fb.idx_odd, d)
            leaves = [t.detach() for t in cc._leaves(fb.groups)]
            for inverse in (False, True):
                tag = f"{str(dtype)[6:]} {model} N={n} " + (
                    "inv" if inverse else "fwd")
                y, ld = cc._launch_fwd(x, leaves, sels, depth, inverse)
                gx, grads = cc._launch_bwd(x, leaves, gy, gld, sels, depth,
                                           inverse)
                out[f"K4 {tag} y"], out[f"K4 {tag} ld"] = y.cpu(), ld.cpu()
                out[f"K5 {tag} gx"] = gx.cpu()
                for i, g in enumerate(grads):
                    out[f"K5 {tag} leaf {i}"] = g.cpu()
    return out


def _policy_outputs(cs, cc) -> dict:
    """K4's and K5's outputs under the bf16 policy at SHAPES, both
    directions, on the CPU."""
    out = {}
    for model, n in SHAPES:
        cfg = cs.CPL_CFG[model]
        fb = cs._perturbed(cs._rnvp(cfg, 30, True)).bijector.bijectors[0]
        d, depth = cfg["q0"], len(cfg["hdims"]) + 1
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn((n, d), generator=gen, device="cuda")
        gy = torch.randn((n, d), generator=gen, device="cuda") / n
        gld = torch.randn((n,), generator=gen, device="cuda") / n
        sels = cc._sels(fb.idx_even, fb.idx_odd, d)
        leaves = [t.detach() for t in cc._leaves(fb.groups)]
        for inverse in (False, True):
            tag = f"{model} N={n} " + ("inv" if inverse else "fwd")
            y, ld = cc._launch_fwd(x, leaves, sels, depth, inverse,
                                   compute_dtype=torch.bfloat16)
            gx, grads = cc._launch_bwd(x, leaves, gy, gld, sels, depth,
                                       inverse, torch.bfloat16)
            out[f"K4 policy {tag} y"] = y.cpu()
            out[f"K4 policy {tag} ld"] = ld.cpu()
            out[f"K5 policy {tag} gx"] = gx.cpu()
            for i, g in enumerate(grads):
                out[f"K5 policy {tag} leaf {i}"] = g.cpu()
    return out


def _policy_times(cs, cc, label="") -> dict:
    """Device times of K4 and K5 under the bf16 policy at CPL_TIMED."""
    ms = {}
    for model, n in cs.CPL_TIMED:
        cfg = cs.CPL_CFG[model]
        fb = cs._perturbed(cs._rnvp(cfg, 30, True)).bijector.bijectors[0]
        d, depth = cfg["q0"], len(cfg["hdims"]) + 1
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn((n, d), generator=gen, device="cuda")
        gy = torch.randn((n, d), generator=gen, device="cuda") / n
        gld = torch.randn((n,), generator=gen, device="cuda") / n
        sels = cc._sels(fb.idx_even, fb.idx_odd, d)
        leaves = [t.detach() for t in cc._leaves(fb.groups)]
        cd = torch.bfloat16
        ms[f"K4 policy{label} {model} N={n}"] = cs.device_ms(
            lambda: cc._launch_fwd(x, leaves, sels, depth, False,
                                   compute_dtype=cd))
        ms[f"K5 policy{label} {model} N={n}"] = cs.device_ms(
            lambda: cc._launch_bwd(x, leaves, gy, gld, sels, depth, False,
                                   cd))
    return ms


def _warps_copy(w: int) -> Path:
    """This checkout's package and ``chip_smoke.py`` under
    build/torch_ab/warps<w>/, its tensor-core kernels at w warps a CTA."""
    root = HERE / "build" / "torch_ab" / f"warps{w}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "normalizingflows_torch",
                    root / "normalizingflows_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", root)
    header = root / "normalizingflows_torch" / "csrc" / "coupling_mma.cuh"
    text, line = header.read_text(), "constexpr int kMmaWarps = 4;"
    if line not in text:
        raise RuntimeError(f"no '{line}' in {header}")
    header.write_text(text.replace(line, f"constexpr int kMmaWarps = {w};"))
    return root


def _k6_outputs(cs) -> dict:
    """K6's losses and final weights on the demo's and the reference
    default's runs, float32 and float64, on the CPU."""
    from normalizingflows_torch.experimental import train_cuda as tc

    out = {}
    for dtype in (torch.float32, torch.float64):
        for model, batch, steps in (("demo", cs.RNVP_BATCH, cs.RNVP_STEPS),
                                    ("ref", cs.RNVP_REF_BATCH,
                                     cs.TRAIN_REF_STEPS)):
            gen = torch.Generator(device="cuda").manual_seed(batch)
            _, args = cs._train_args(cs.CPL_CFG[model], dtype, batch, steps,
                                     0, gen, perturb=False)
            res = tc.adam_train_realnvp_fused(*args, backend="cuda")
            tag = f"K6 {str(dtype)[6:]} {model} batch {batch}"
            for i, t in enumerate(cs._train_outputs(res)):
                out[f"{tag} {'losses' if i == 0 else f'leaf {i}'}"] = t.cpu()
    return out


def _times(cs, cc, k4_n) -> dict:
    import normalizingflows_torch as nft

    ms = {}
    for model, n in cs.CPL_TIMED + tuple(("demo", n) for n in k4_n):
        cfg = cs.CPL_CFG[model]
        fb = cs._perturbed(cs._rnvp(cfg, 30, True)).bijector.bijectors[0]
        d, depth = cfg["q0"], len(cfg["hdims"]) + 1
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn((n, d), generator=gen, device="cuda")
        gy = torch.randn((n, d), generator=gen, device="cuda") / n
        gld = torch.randn((n,), generator=gen, device="cuda") / n
        sels = cc._sels(fb.idx_even, fb.idx_odd, d)
        leaves = [t.detach() for t in cc._leaves(fb.groups)]
        ms[f"K4 {model} N={n}"] = cs.device_ms(
            lambda: cc._launch_fwd(x, leaves, sels, depth, False))
        if n not in k4_n:
            ms[f"K5 {model} N={n}"] = cs.device_ms(
                lambda: cc._launch_bwd(x, leaves, gy, gld, sels, depth,
                                       False))
    target = nft.Banana(2, 1.0, 100.0)
    gen = torch.Generator(device="cuda").manual_seed(80)
    for model, batch, steps in (("demo", cs.RNVP_BATCH, cs.RNVP_STEPS),
                                ("ref", cs.RNVP_REF_BATCH,
                                 cs.TRAIN_REF_STEPS)):
        flow = cs._rnvp(cs.CPL_CFG[model], 0, True)
        _, dt, launch_ms, _ = cs._timed_train(flow, gen, target, batch, steps)
        ms[f"K6 {model} batch {batch} ms a step"] = sum(launch_ms) / steps
        ms[f"K6 {model} batch {batch} steps/s"] = steps / dt
    return ms


def _rqs_inputs(cs, n, K, dtype, seed):
    """x over [−1.5B, 1.5B], elem-major raw (the wide layout's view at
    131,072), gy and gld, on the card from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    P, n_t = 3 * K - 1, 32 if n == WIDE_N else 1
    x = (torch.rand((n,), generator=gen, device="cuda", dtype=dtype) * 3
         - 1.5) * cs.B
    raw = 3.0 * torch.randn((n // n_t, n_t * P), generator=gen, device="cuda",
                            dtype=dtype).view(n, P)
    gy = torch.randn((n,), generator=gen, device="cuda", dtype=dtype)
    gld = torch.randn((n,), generator=gen, device="cuda", dtype=dtype)
    return x, raw, gy, gld, gen


def _digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


def _rqs_outputs(cs, rq) -> dict:
    """K1's (y, ld) and K2's or K3's (gx, graw) in three layouts of raw."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        for K in (8, 10):
            for n in RQS_N:
                x, raw, gy, gld, gen = _rqs_inputs(cs, n, K, dtype, 10 * n + K)
                padded = torch.cat([raw, torch.randn(
                    (n, 3), generator=gen, device="cuda", dtype=dtype)], 1)
                layouts = {
                    "dense": (raw, lambda a, r, inv: rq.rqs_fused(
                        a, r, cs.B, inverse=inv, backend="cuda")),
                    "padded": (padded, lambda a, r, inv: rq.rqs_fused_e(
                        a, r, cs.B, K, inverse=inv, backend="cuda")),
                    "param-major": (raw.T.contiguous(),
                                    lambda a, r, inv: rq.rqs_fused_t(
                                        a, r, cs.B, inverse=inv,
                                        backend="cuda"))}
                for inverse in (False, True):
                    for layout, (r, fused) in layouts.items():
                        y, ld, gx, graw = cs._grads(
                            lambda a, rr: fused(a, rr, inverse), x, r, gy,
                            gld)
                        tag = (f"{str(dtype)[6:]} K={K} N={n} {layout} "
                               f"{'inv' if inverse else 'fwd'}")
                        kb = "K3" if inverse else "K2"
                        out[f"K1 {tag} y"], out[f"K1 {tag} ld"] = \
                            _digest(y), _digest(ld)
                        out[f"{kb} {tag} gx"], out[f"{kb} {tag} graw"] = \
                            _digest(gx), _digest(graw)
    return out


def _rqs_times(cs, rq) -> dict:
    ms, K = {}, 10
    flush = torch.empty(16 << 20, device="cuda")  # 64 MiB, over the L2
    flush_ms = cs.device_ms(flush.zero_)
    for n in RQS_TIMED:
        x, raw, gy, gld, _ = _rqs_inputs(cs, n, K, torch.float32, n)
        calls = {
            "K1": lambda: rq._launch_fwd(x, raw, cs.B, K, False),
            "K1 inv": lambda: rq._launch_fwd(x, raw, cs.B, K, True),
            "K2": lambda: rq._launch_bwd(x, raw, gy, gld, cs.B, K, False),
            "K3": lambda: rq._launch_bwd(x, raw, gy, gld, cs.B, K, True)}
        for name, fn in calls.items():
            ms[f"{name} N={n}"] = cs.device_ms(fn)
            if n == WIDE_N:
                ms[f"{name} N={n} cold"] = cs.device_ms(
                    lambda: (flush.zero_(), fn())) - flush_ms
    return ms


def worker(root: Path, out: Path, k4_n, warps=None) -> None:
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from normalizingflows_torch.experimental import coupling_cuda as cc
    from normalizingflows_torch.experimental import train_cuda as tc
    from normalizingflows_torch.ops import rqs_cuda as rq

    from normalizingflows_torch.ops import _build

    for mod in (cs, cc, tc, rq, _build):
        if not Path(mod.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"imported {mod.__file__}, not {root}'s "
                               f"package")
    build = _build.build()  # its ptxas report where this run built it
    if warps is not None:  # a copy at `warps` warps a CTA: its policy times
        first, again = (_policy_times(cs, cc, f" w={warps}") for _ in (0, 1))
        torch.save({"ms": {k: [first[k], again[k]] for k in first}}, out)
        return
    torch.save({"outputs": {**_outputs(cs, cc), **_policy_outputs(cs, cc),
                            **_k6_outputs(cs), **_rqs_outputs(cs, rq)},
                "ms": {**_times(cs, cc, k4_n), **_policy_times(cs, cc),
                       **_rqs_times(cs, rq)},
                "registers": {k: [regs, stores, loads] for k, regs, stores,
                              loads in cs.ptxas_report(build.log)}}, out)


def _k4_switch_n() -> tuple:
    """The demo's last N on this checkout's K4 lane tile in float32, and
    one past it."""
    sys.path.insert(0, str(HERE))
    from normalizingflows_torch.experimental import coupling_cuda as cc

    n = cc.bwd_rows(4, 16) * cc.FWD_LANE_MAX_TILES
    return n, n + 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="the other checkout")
    parser.add_argument("--out", help="also write the JSON here")
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--result", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--k4-n", help=argparse.SUPPRESS)
    parser.add_argument("--warps", type=int, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.worker:
        worker(args.worker.resolve(), args.result,
               tuple(int(n) for n in args.k4_n.split(",")), args.warps)
        return 0
    k4_n = ",".join(str(n) for n in _k4_switch_n())
    parent = args.parent.resolve()
    scratch = HERE / "build" / "torch_ab"
    scratch.mkdir(parents=True, exist_ok=True)
    order = (("parent", parent), ("change", HERE), ("change", HERE),
             ("parent", parent))
    runs = []
    for i, (label, root) in enumerate(order):
        result = scratch / f"run{i}.pt"
        subprocess.run([sys.executable, __file__, "--worker", str(root),
                        "--result", str(result), "--k4-n", k4_n],
                       check=True, cwd=root)
        runs.append((label, torch.load(result)))
    warps_ms = {}
    for w in (1, 2, 4, 8):
        root, result = _warps_copy(w), scratch / f"warps{w}.pt"
        subprocess.run([sys.executable, __file__, "--worker", str(root),
                        "--result", str(result), "--k4-n", k4_n,
                        "--warps", str(w)], check=True, cwd=root)
        warps_ms.update(torch.load(result)["ms"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    p0, c1, c2 = runs[0][1]["outputs"], runs[1][1]["outputs"], \
        runs[2][1]["outputs"]

    def same(a, b, prefix):
        keys = [k for k in a if k.startswith(prefix)]
        return sum(torch.equal(a[k], b[k]) if torch.is_tensor(a[k])
                   else a[k] == b[k] for k in keys), len(keys)

    bits = {}
    for prefix in ("K1 float32", "K1 float64", "K2 float32", "K2 float64",
                   "K3 float32", "K3 float64", "K4 float32", "K4 float64",
                   "K5 float32 demo", "K5 float32", "K5 float64",
                   "K4 policy", "K5 policy", "K6 float32", "K6 float64"):
        bits[prefix] = {"parent_vs_change": same(p0, c1, prefix),
                        "change_twice": same(c1, c2, prefix)}
    # each tree's register report (its first run built it): the
    # instantiations both trees have, and whether they take the same
    registers = {label: {} for label in ("parent", "change")}
    for label, r in runs:
        registers[label].update(r.get("registers", {}))
    both = sorted(set(registers["parent"]) & set(registers["change"]))
    keys = list(dict.fromkeys(k for _, r in runs for k in r["ms"]))
    result = {"card": smi, "device": torch.cuda.get_device_name(0),
              "order": [label for label, _ in order],
              "ms": {k: [r["ms"].get(k) for _, r in runs] for k in keys},
              "policy_ms_by_warps": warps_ms,
              "identical_bits": bits,
              "registers": registers,
              "registers_differ": {k: (registers["parent"][k],
                                       registers["change"][k])
                                   for k in both if registers["parent"][k]
                                   != registers["change"][k]}}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
