"""K4, K5 and K6 of two checkouts of this repository on one GPU, in turns.

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
  N 262,144;
* K6 through ``train_realnvp_fused``: the demo (1,000 steps, batch 16) and
  the reference default (50 steps, batch 256), device time a step by CUDA
  events around each launch (``chip_smoke._timed_train``), and steps/s.

Prints one JSON object (and writes it to ``--out``): the card, each run's
times, and per output whether DIR and this checkout gave identical bits
and whether this checkout's two runs did. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
SHAPES = (("demo", 16), ("demo", 300), ("ref", 256), ("odd", 300))


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


def _times(cs, cc) -> dict:
    import normalizingflows_torch as nft

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
        ms[f"K4 {model} N={n}"] = cs.device_ms(
            lambda: cc._launch_fwd(x, leaves, sels, depth, False))
        ms[f"K5 {model} N={n}"] = cs.device_ms(
            lambda: cc._launch_bwd(x, leaves, gy, gld, sels, depth, False))
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


def worker(root: Path, out: Path) -> None:
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from normalizingflows_torch.experimental import coupling_cuda as cc

    if not Path(cc.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {cc.__file__}, not {root}'s package")
    torch.save({"outputs": _outputs(cs, cc), "ms": _times(cs, cc)}, out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="the other checkout")
    parser.add_argument("--out", help="also write the JSON here")
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--result", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.worker:
        worker(args.worker.resolve(), args.result)
        return 0
    parent = args.parent.resolve()
    scratch = HERE / "build" / "torch_ab"
    scratch.mkdir(parents=True, exist_ok=True)
    order = (("parent", parent), ("change", HERE), ("change", HERE),
             ("parent", parent))
    runs = []
    for i, (label, root) in enumerate(order):
        result = scratch / f"run{i}.pt"
        subprocess.run([sys.executable, __file__, "--worker", str(root),
                        "--result", str(result)], check=True, cwd=root)
        runs.append((label, torch.load(result)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    p0, c1, c2 = runs[0][1]["outputs"], runs[1][1]["outputs"], \
        runs[2][1]["outputs"]

    def same(a, b, prefix):
        keys = [k for k in a if k.startswith(prefix)]
        return sum(torch.equal(a[k], b[k]) for k in keys), len(keys)

    bits = {}
    for prefix in ("K4 float32", "K4 float64", "K5 float32 demo",
                   "K5 float32", "K5 float64"):
        bits[prefix] = {"parent_vs_change": same(p0, c1, prefix),
                        "change_twice": same(c1, c2, prefix)}
    result = {"card": smi, "device": torch.cuda.get_device_name(0),
              "order": [label for label, _ in order],
              "ms": {k: [r["ms"][k] for _, r in runs]
                     for k in runs[0][1]["ms"]},
              "identical_bits": bits}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
