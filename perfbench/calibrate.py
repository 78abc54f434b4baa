"""The readings that a cell's limits are set from (`limits/<cell>.json`),
on the card, at the cell's own sizes, many seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 101 102 ... \
        [--faults 3] [--seconds 1] [--out FILE]

For each seed it prints one JSON line with the readings of

* ``program``: the port, as a run of the cell reads them (a short window);
* ``control``: the plain reference computed in TF32 (every matmul operand
  rounded to 10 mantissa bits, float32 sums), put in the program's place
  (on the first ``--controls`` seeds; in training its own Adam trajectory
  from the seed on every step's draws);
* on the first ``--faults`` seeds of a training cell, ``half_batch``: the
  port with its objective taking the mean over half of each batch.

A step that leaves the weights unchanged reads 1 on ``update`` by its
definition and needs no run. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def half_batch(nft):
    """The objective of the timed path, with half of each batch left out
    and the mean taken over the rest."""
    orig = nft.objectives.elbo_from_samples

    def half(xs, flow, logp):
        return orig(xs[: xs.shape[0] // 2], flow, logp)

    return half


def train_readings(run, fault=None, with_control=True):
    from perfbench import systems
    from perfbench.drivers import train_elbo as drv

    nft = systems.program()
    orig = nft.objectives.elbo_from_samples
    if fault == "half_batch":
        nft.objectives.elbo_from_samples = half_batch(nft)
    try:
        _, _, _, _, program, states = drv._program(run)
    finally:
        nft.objectives.elbo_from_samples = orig
    steps = program["steps"]
    w0 = drv.seed_weights(run)
    out = {"program": drv.readings(
        program, run, drv.reference_draws(run, states, steps), w0)}
    if fault is None and with_control:
        every = drv.reference_draws(run, states, range(1, steps[-1] + 1))
        ctl = drv.control(run, [every[k] for k in sorted(every)], w0, steps)
        out["control"] = drv.readings(ctl, run, every, w0)
    return out


def sample_readings(run):
    from perfbench.drivers import sample as drv

    _, _, _, _, kept = drv._program(run)
    prog = [(y, lq) for _, y, lq in kept]
    ref = [drv.reference_of(run, st) for st, _, _ in kept]
    ctl = [drv.reference_of(run, st, "tf32") for st, _, _ in kept]
    states = [st for st, _, _ in kept]
    return {"program": drv.readings(prog, ref, states),
            "control": drv.readings(ctl, ref, states)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--controls", type=int, default=10 ** 9,
                    help="seeds (the first) on which the control runs")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    import torch

    from perfbench import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    lines = []
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        run = harness.Run(cell, seed, args.seconds, False,
                          torch.device("cuda"), time.perf_counter())
        if cell.traffic["kind"] == "train_elbo":
            row = train_readings(run, with_control=i < args.controls)
            if i < args.faults:
                row["half_batch"] = train_readings(run, "half_batch")[
                    "program"]
        else:
            row = sample_readings(run)
        row.update(seed=seed, seconds=time.perf_counter() - t)
        torch.cuda.empty_cache()
        line = json.dumps(row)
        print(line, flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
