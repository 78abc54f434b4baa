#!/usr/bin/env python3
"""The spread of `chip_smoke.py` phase 47's weight-gradient ratio for the
bf16 policy's K5 over many draws, on the card:

    python benchmarks/torch_leaf_scan.py [--seeds 256] [--n 262144]
        [--out FILE]

For each seed, the demo's perturbed seed-30 stack (d=2, [16,16]x3) under
the policy at N rows, forward and inverse, on `chip_smoke._policy_draws`
from a generator of that seed (`chip_smoke.policy_leaf_reading`): each
weight gradient's relative L2 error against the plain version over the
float32 K5's against the float32 plain version (the ratio phase 47 holds
to LEAF_FACTOR, `_leaf_check`), and the same ratio for the plain version
with its products summed in float64 (`_dot_witness`, the same roundings
in another order) on the same draw. A fault of the kernel moves its ratio
away from the witness's; roundoff that flips a bfloat16 rounding moves
both. Prints one JSON object (and writes it to ``--out``): the quantiles
of the largest ratio a draw, the draws past the gate, and the worst
draws with the witness beside them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from normalizingflows_torch.experimental import (  # noqa: E402
    coupling_cuda as cc)


def _quantiles(values) -> dict:
    v = sorted(values)
    return {f"q{q}": v[min(len(v) - 1, int(q / 100 * len(v)))]
            for q in (50, 90, 99)} | {"max": v[-1]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=256)
    parser.add_argument("--n", type=int, default=262144)
    parser.add_argument("--out", help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    t0 = time.perf_counter()
    floor = cs.LEAF_FLOOR
    draws = []
    for seed in range(args.seeds):
        for inverse in (False, True):
            leaves = cs.policy_leaf_reading(cc, args.n, seed, inverse)
            i, (e, e32, w) = max(enumerate(leaves),
                                 key=lambda t: t[1][0] / max(t[1][1], floor))
            draws.append(dict(
                seed=seed, inverse=inverse, leaf=i, err=e, err32=e32,
                ratio=e / max(e32, floor), witness_ratio=w / max(e32, floor),
                gate_fails=any(a > cs.LEAF_FACTOR * b + floor
                               for a, b, _ in leaves)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    result = {
        "card": smi, "n": args.n, "seeds": args.seeds,
        "leaf_factor": cs.LEAF_FACTOR,
        "ratio": {dr: _quantiles([d["ratio"] for d in draws
                                  if d["inverse"] == (dr == "inverse")])
                  for dr in ("forward", "inverse")},
        "witness_ratio": {dr: _quantiles(
            [d["witness_ratio"] for d in draws
             if d["inverse"] == (dr == "inverse")])
            for dr in ("forward", "inverse")},
        "gate_fails": [d for d in draws if d["gate_fails"]],
        "worst": sorted(draws, key=lambda d: -d["ratio"])[:8],
        "seconds": time.perf_counter() - t0,
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
