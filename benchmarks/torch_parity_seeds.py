#!/usr/bin/env python3
"""Spread of a parity row's final quality over the seeds of its draws.

A row of `normalizingflows_torch/examples/parity.py` starts from a fixed
init (seed 0) and draws its training batches and ELBO estimates from
generators of one seed (123, as the JAX row's keys). This script reruns
rows at other seeds, the init unchanged, to show how far the final ELBO
(held-out log-likelihood for MAF) moves with the draws alone: the yardstick
for a row that misses its band against the JAX row. On the card unless
``--device cpu``:

    python benchmarks/torch_parity_seeds.py \\
        --workload realnvp_k6,hamiltonian --seeds 123,124,125,126,127 \\
        --out build/parity_seeds.json

It prints one JSON line a run and, at the end, each row's mean, standard
deviation and range over the seeds, beside the JAX row of
benchmarks/PARITY.json (read only).

``--numpy-draws`` runs the RealNVP or Hamiltonian row's recipe instead on
host draws from numpy's generator of each seed (the row's init, its
optimizer, one chunk of every step's base draws through `scan_inputs` and
`elbo_from_samples`), scored by the ELBO on 65,536 numpy draws of seed 99
and the last tenth of the training ELBO: the same run on the CPU and on
the card, so that the two devices can be compared on identical inputs
(`tests/_parity_shared_draws.py` runs the same protocol in both packages
on the CPU):

    python benchmarks/torch_parity_seeds.py --numpy-draws \\
        --workload realnvp --seeds 1,2,3 --device cpu
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from normalizingflows_torch.examples import parity  # noqa: E402
from normalizingflows_torch.utils.device import resolve_device  # noqa: E402

KEYS = ("elbo_after", "elbo_after_sem", "elbo_train_tail", "iters_per_s",
        "sliced_w2", "grid_tv")
EVAL_DRAWS = 65536


def numpy_draws_run(name, steps, seed, device):
    """The row's recipe on numpy draws of ``seed``: (ELBO on 65,536 numpy
    draws of seed 99, training ELBO over the last tenth, seconds)."""
    import numpy as np
    import torch

    import normalizingflows_torch as nft
    from normalizingflows_torch.models.hamiltonian import joint_logp

    if name == "realnvp":
        flow = nft.realnvp(torch.Generator().manual_seed(0), 2, (16, 16),
                           nlayers=3, device=device)
        logp, lr, dim, dt = (nft.Banana(2, 1.0, 100.0).log_prob, 5e-4, 2,
                             np.float32)
    elif name == "hamiltonian":
        t = nft.Funnel(2, -8.0, 5.0)
        flow = nft.hamiltonian_flow(2, t.score, n_blocks=15, L=3, eps0=0.05,
                                    dtype=torch.float64, device=device)
        logp, lr, dim, dt = joint_logp(t.log_prob, 2), 3e-4, 4, np.float64
    else:
        raise ValueError(f"--numpy-draws has no recipe for {name!r}")
    draws = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (steps, 16, dim)).astype(dt))
    t0 = time.perf_counter()
    res = nft.train_flow(torch.Generator(device=device),
                         nft.elbo_from_samples, flow, logp, max_iters=steps,
                         check_every=steps, optimizer=nft.optim.adam(lr),
                         scan_inputs=lambda g, f, n: draws)
    seconds = time.perf_counter() - t0
    ev = torch.from_numpy(np.random.default_rng(99).standard_normal(
        (EVAL_DRAWS, dim)).astype(dt)).to(device)
    with torch.no_grad():
        elbo = float(nft.elbo_from_samples(ev, res.flow, logp))
    k = max(steps // 10, 1)
    return elbo, -float(res.stats["loss"][-k:].mean()), seconds


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True,
                   help="comma-separated names of parity.WORKLOADS")
    p.add_argument("--seeds", default="123,124,125,126,127")
    p.add_argument("--iters", type=int, default=None,
                   help="steps (default: the row's full count)")
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--numpy-draws", action="store_true",
                   help="the row's recipe on numpy draws (realnvp, "
                        "hamiltonian)")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    if a.numpy_draws:
        out = []
        for name in a.workload.split(","):
            steps = a.iters or parity.WORKLOADS[name][1]
            for seed in (int(x) for x in a.seeds.split(",")):
                elbo, tail, seconds = numpy_draws_run(name, steps, seed,
                                                      device)
                out.append({"workload": name, "steps": steps, "seed": seed,
                            "elbo": elbo, "train_tail": tail,
                            "seconds": seconds, "device": str(device)})
                print(json.dumps(out[-1]), flush=True)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            Path(a.out).write_text(json.dumps(out, indent=1))
        return out
    reference = json.loads(parity.REFERENCE.read_text())
    seeds = [int(s) for s in a.seeds.split(",")]
    runs, summary = {}, {}
    for name in a.workload.split(","):
        fn, full, _ = parity.WORKLOADS[name]
        for seed in seeds:
            t0 = time.perf_counter()
            row = fn(a.iters or full, device, None, seed=seed)
            run = {k: row.get(k) for k in KEYS}
            run.update(workload=name, seed=seed, iters=row["iters"],
                       seconds=time.perf_counter() - t0,
                       device=row["device"])
            runs.setdefault(name, []).append(run)
            print(json.dumps(run), flush=True)
        values = [r["elbo_after"] for r in runs[name]]
        ref = reference[parity.JAX_ROW.get(row["workload"], row["workload"])]
        summary[name] = {
            "seeds": seeds, "elbo_after": values,
            "mean": statistics.mean(values),
            "stdev": statistics.stdev(values) if len(values) > 1 else 0.0,
            "min": min(values), "max": max(values),
            "jax_elbo_after": ref["elbo_after"],
            "passes": [parity.band(r | {"iters": r["iters"]}, ref)["pass"]
                       for r in runs[name]]}
        print(json.dumps({"spread": {name: summary[name]}}), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({"runs": runs,
                                           "summary": summary}, indent=1))
    return summary


if __name__ == "__main__":
    main()
