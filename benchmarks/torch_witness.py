#!/usr/bin/env python3
"""Readings behind `chip_smoke.py` phase 47's checks of the bf16 policy's
K4/K5 on deep stacks, on the card:

    python benchmarks/torch_witness.py [--out FILE]

For the reference default (d=2, [32,32]x10) at 256 rows (three draws) and
4,096 rows, and for the stack at the kernels' bounds (d=8, [32,32,32]x10)
at 4,096 rows (two draws), forward and inverse, from the perturbed seed-30
stacks and draws of one generator seeded 47: for the kernels
(``coupling_stack_fused(backend="cuda")``) and for the plain version with
its products summed in float64 (`chip_smoke._dot_witness`), each output
against the plain version,

* the largest excess over CPL_BF16_TOL (negative: within it) of y, ld, gx
  and the weight gradients;
* the share of y, ld and gx outside FLIP_TOL;
* the weight gradients' largest ratio to the float32 K5's error
  (`chip_smoke._leaf_ratio`);

and `chip_smoke._witness_check`'s ratios: the kernels' relative L2 error
over the witness's by output, and that of each faulty product of
WITNESS_CONTROLS in its largest output. Prints one JSON object (and writes
it to ``--out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from normalizingflows_torch.experimental import (  # noqa: E402
    coupling_cuda as cc)


def _excess(a, b, tol):
    a, b = a.detach().double(), b.detach().double()
    return float(((a - b).abs() - (tol[1] + tol[0] * b.abs())).max())


def _readings(fb, x, gy, gld, sels, inverse, outs, plain, n):
    tol = cs.CPL_BF16_TOL["f32_cbf16"]
    return dict(
        excess_y=_excess(outs[0], plain[0], tol["y"]),
        excess_ld=_excess(outs[1], plain[1], tol["ld"]),
        excess_gx=_excess(outs[2], plain[2], (tol["gx"][0],
                                              tol["gx"][1] / n)),
        excess_leaves=max(_excess(a, b, (tol["g"][0], tol["g"][1] * min(
            1.0, float(b.abs().max())))) for a, b in zip(outs[3:],
                                                         plain[3:])),
        flips=[cs._flipped_share("", a, b) for a, b in (
            (outs[0], plain[0]), (outs[1], plain[1]),
            (outs[2] * n, plain[2] * n))],
        leaf_ratio=cs._leaf_ratio(cc, fb, x, gy, gld, sels, inverse,
                                  outs[3:], plain[3:]))


def case(cfg, n, gen, key):
    """Both directions of one stack at n rows: the kernels' and the
    witness's readings, and the witness check's ratios."""
    cd = torch.bfloat16
    fb = cs._bf16_fused(cfg, "f32_cbf16")
    sels = cc._sels(fb.idx_even, fb.idx_odd, cfg["q0"])
    leaves = cc._leaves(fb.groups)
    x, _ = cs._off_kinks(cc, torch.randn((n, cfg["q0"]), generator=gen,
                                         device=cs.DEVICE), fb.groups, sels,
                         gen, cd)
    gy = torch.randn((n, cfg["q0"]), generator=gen, device=cs.DEVICE) / n
    gld = torch.randn((n,), generator=gen, device=cs.DEVICE) / n
    out = {}
    for inverse in (False, True):
        xg = x.detach().requires_grad_()
        y, ld = cc.coupling_stack_fused(xg, fb.groups, fb.idx_even,
                                        fb.idx_odd, inverse=inverse,
                                        backend="cuda", compute_dtype=cd)
        got = [y.detach(), ld.detach(), *torch.autograd.grad(
            (y, ld), [xg] + leaves, (gy, gld))]
        args = (fb, x, gy, gld, sels, inverse, cd)
        plain = cs._plain_on(cc, None, *args)
        witness = cs._plain_on(cc, cs._dot_witness, *args)
        seen = dict(witness={}, controls={})
        failed = cs._witness_check(cc, *args, got, key, seen, key)
        out["inv" if inverse else "fwd"] = dict(
            kernel=_readings(fb, x, gy, gld, sels, inverse, got, plain, n),
            witness=_readings(fb, x, gy, gld, sels, inverse, witness, plain,
                              n),
            witness_ratios=seen["witness"][key],
            controls=seen["controls"][key], witness_failed=len(failed))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(47)
    res = {f"ref256 #{i}": case(cs.RNVP_REF, 256, gen, "ref")
           for i in range(3)}
    res["ref4096"] = case(cs.RNVP_REF, 4096, gen, "ref")
    for i in range(2):
        res[f"deep4096 #{i}"] = case(cs.RNVP_DEEP, 4096, gen, "deep")
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
