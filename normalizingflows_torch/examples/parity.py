"""Parity harness of the port: the workloads of `benchmarks/parity.py` run
to convergence on the port, and each final ELBO held against the JAX row.

Counterpart of `benchmarks/parity.py` (which stays the JAX package's): the
same eight `WORKLOADS` with the same full and quick step counts and the same
recipes (flow, dtype, batch, optimizer, N_EVAL, N_MOMENT, ``eval_reps``;
the ``nsf`` row's Adam under the warmup-cosine schedule of `optim.py`),
each row with the JSON fields of the JAX harness's `_run` / `_run_mle`.
Two more routes train the RealNVP row's recipe through the hand-written
kernels: ``realnvp_fused`` (`realnvp(fused=True)` through `train_flow`, one
K4 and one K5 a step) and ``realnvp_k6`` (`train_realnvp_fused`, K6 in
launches of 512 steps).

Usage (on the card unless ``--device cpu``):

    python -m normalizingflows_torch.examples.parity --workload all \\
        --out build/parity_torch.json
    python -m normalizingflows_torch.examples.parity --workload nsf --quick

Each row function takes ``seed`` (default 123, as the JAX rows'): the
seeds of its evaluation and training draws; the flow's init is the row's
own (seed 0). The JSON at ``--out`` holds ``{"rows": {workload: row},
"bands": {...}}``; figures (where matplotlib is present) go to
``figures/`` beside it. The
band (`band`): a port row passes when its final ELBO (held-out mean
log-likelihood for MAF) is no lower than the JAX row's in
``--reference`` (default `benchmarks/PARITY.json`, read only) less the
larger of 0.05 nat and three times the two rows' SEMs added together. The
random streams differ (Philox against threefry), so only the final
quality is compared.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import time
from pathlib import Path

import torch

import normalizingflows_torch as nft
from normalizingflows_torch.models.hamiltonian import joint_logp
from normalizingflows_torch.utils.data import make_loader
from normalizingflows_torch.utils.device import resolve_device

N_EVAL = 4096     # MC samples for final ELBO estimates
N_MOMENT = 65536  # samples for moment comparison
REFERENCE = Path(__file__).resolve().parents[2] / "benchmarks" / "PARITY.json"
BAND_NATS, BAND_SEMS = 0.05, 3.0


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _moments(samples):
    return samples.mean(dim=0), samples.std(dim=0, unbiased=False)


def _figure(fig_dir, name, trained, untrained, target_samples):
    """Trained-vs-untrained-vs-target scatter overlay PNG, as the JAX
    harness draws it. Returns the saved path, or None without
    matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    if fig_dir is None:
        return None
    fig_dir.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 6))
    n = 4096
    for s, label, color, alpha in [
        (target_samples, "target", "tab:green", 0.35),
        (untrained, "untrained flow", "tab:orange", 0.35),
        (trained, "trained flow", "tab:blue", 0.45),
    ]:
        s = s[:n].cpu().numpy()
        ax.scatter(s[:, 0], s[:, 1], s=4, alpha=alpha, color=color,
                   label=label, linewidths=0)
    ax.legend(loc="best")
    ax.set_title(name)
    ax.set_xlabel("x[0]")
    ax.set_ylabel("x[1]")
    fig.tight_layout()
    path = fig_dir / f"{name}.png"
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return str(path)


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def _sample_moments(flow, untrained, target_sampler, project, device):
    """What the JAX harness computes after training: N_MOMENT draws of the
    trained and untrained flow (one seed) and of the target, their
    moments, SW₂ and grid TV against a second set of target draws (the
    floor)."""
    with torch.no_grad():
        flow_samples = flow.sample(_gen(device, 2), (N_MOMENT,))
        untrained_samples = untrained.sample(_gen(device, 2), (N_MOMENT,))
        if project is not None:
            flow_samples = project(flow_samples)
            untrained_samples = project(untrained_samples)
        target_samples = target_sampler(_gen(device, 3), N_MOMENT)
        target_b = target_sampler(_gen(device, 12), N_MOMENT)
        fm, fs = _moments(flow_samples)
        tm, ts = _moments(target_samples)
        sw2 = float(nft.sliced_wasserstein2(_gen(device, 11), flow_samples,
                                            target_samples))
        sw2_floor = float(nft.sliced_wasserstein2(_gen(device, 11), target_b,
                                                  target_samples))
        tv = float(nft.grid_total_variation(flow_samples, target_samples))
        tv_floor = float(nft.grid_total_variation(target_b, target_samples))
    return {
        "mean_flow": [round(float(v), 4) for v in fm],
        "mean_target": [round(float(v), 4) for v in tm],
        "std_flow": [round(float(v), 4) for v in fs],
        "std_target": [round(float(v), 4) for v in ts],
        "max_abs_mean_err": round(float((fm - tm).abs().max()), 4),
        "max_abs_std_err": round(float((fs - ts).abs().max()), 4),
        "mc_sem": round(float(ts.max()) / math.sqrt(N_MOMENT), 5),
        "sliced_w2": round(sw2, 4),
        "sliced_w2_floor": round(sw2_floor, 4),
        "grid_tv": round(tv, 4),
        "grid_tv_floor": round(tv_floor, 4),
    }, (flow_samples, untrained_samples, target_samples)


def _run(name, flow, target_logp, target_sampler, objective, n_per_iter,
         optimizer, max_iters, check_every, device, seed=123, project=None,
         n_eval=N_EVAL, eval_reps=1, trainer=None, fig_dir=None):
    """`benchmarks/parity.py`'s `_run` on the port: ELBO before and after
    (mean ± SEM over ``eval_reps`` estimates of ``n_eval`` draws), the
    training (``trainer(generator, flow, max_iters)``, by default
    `train_flow` with the row's objective and optimizer), the tail ELBO,
    iters/s (training and the final estimate, as JAX times them) and the
    sample evidence."""
    untrained = copy.deepcopy(flow)

    def eval_elbo(f, seed_):
        # mean ± sem over eval_reps independent estimates
        g = _gen(device, seed_)
        with torch.no_grad():
            vals = [float(nft.elbo_batch(g, f, target_logp, n_eval))
                    for _ in range(eval_reps)]
        mean = sum(vals) / len(vals)
        if len(vals) > 1:
            var = sum((v - mean) ** 2 for v in vals) / (len(vals) - 1)
            sem = math.sqrt(var / len(vals))
        else:
            sem = 0.0
        return mean, sem

    if trainer is None:
        def trainer(gen, f, iters):
            return nft.train_flow(gen, objective, f, target_logp, n_per_iter,
                                  max_iters=iters, optimizer=optimizer,
                                  check_every=check_every)

    before, before_sem = eval_elbo(flow, seed)
    t0 = time.perf_counter()
    res = trainer(_gen(device, seed + 1), flow, max_iters)
    after, after_sem = eval_elbo(res.flow, 7)
    wall = time.perf_counter() - t0
    tail = res.stats["loss"][-max(max_iters // 10, 1):]
    tail_elbo = -float(sum(tail) / len(tail))

    evidence, samples = _sample_moments(res.flow, untrained, target_sampler,
                                        project, device)
    return {
        "workload": name,
        "iters": int(max_iters),
        "elbo_before": round(before, 4),
        "elbo_after": round(after, 4),
        "elbo_before_sem": round(before_sem, 4),
        "elbo_after_sem": round(after_sem, 4),
        "elbo_train_tail": round(tail_elbo, 4),
        "iters_per_s": round(max_iters / wall, 1),
        **evidence,
        "figure": _figure(fig_dir, name, *samples),
        "improved_significant": bool(
            after - before > 2.0 * (before_sem + after_sem)
        ),
        "device": _device_name(device),
    }


def _target_sampler(t, dtype=None):
    """Exact target draws on the generator's device, in ``dtype`` (a
    mixture draws in its own)."""
    if dtype is None:
        return lambda g, n: t.sample(g, (n,))
    return lambda g, n: t.sample(g, (n,), dtype=dtype)


def planar(iters, device, fig_dir=None, seed=123):
    """`example/demo_planar_flow.jl:16-48`: Banana(2,1,10), f64, 10 layers,
    32 samples/iter, Adam(1e-2), elbo_batch."""
    dtype = torch.float64
    t = nft.Banana(2, 1.0, 10.0)
    flow = nft.planarflow(torch.Generator().manual_seed(0),
                          nft.DiagNormal.standard(2, dtype, device),
                          nlayers=10, dtype=dtype, device=device)
    return _run("planar_banana_easy", flow, t.log_prob,
                _target_sampler(t, dtype), nft.elbo_batch, 32,
                nft.optim.adam(1e-2), iters, max(iters // 10, 1), device,
                seed=seed, fig_dir=fig_dir)


def radial(iters, device, fig_dir=None, seed=123):
    """`example/demo_radial_flow.jl:16-49`: WarpedGauss, f64, 10 layers,
    32 samples/iter, Adam(1e-2), elbo_batch."""
    dtype = torch.float64
    t = nft.WarpedGauss(1.0, 0.12)
    flow = nft.radialflow(torch.Generator().manual_seed(0),
                          nft.DiagNormal.standard(2, dtype, device),
                          nlayers=10, dtype=dtype, device=device)
    return _run("radial_warpedgauss", flow, t.log_prob,
                _target_sampler(t, dtype), nft.elbo_batch, 32,
                nft.optim.adam(1e-2), iters, max(iters // 10, 1), device,
                seed=seed, fig_dir=fig_dir)


def _realnvp(name, iters, device, fig_dir, seed, fused=False, k6=False):
    """`example/demo_RealNVP.jl:20-61`: hard Banana(2,1,100), f32, 3 layers
    [16,16], 16 samples/iter, Adam(5e-4), elbo_batch (≈50k to converge);
    unfused, fused (K4/K5 a step) or by the whole-run kernel K6."""
    t = nft.Banana(2, 1.0, 100.0)
    flow = nft.realnvp(torch.Generator().manual_seed(0), 2, (16, 16),
                       nlayers=3, device=device, fused=fused or k6)
    trainer = None
    if k6:
        def trainer(gen, f, n):
            return nft.train_realnvp_fused(gen, f, t, 16, max_iters=n,
                                           learning_rate=5e-4)
    return _run(name, flow, t.log_prob, _target_sampler(t, torch.float32),
                nft.elbo_batch, 16, nft.optim.adam(5e-4), iters,
                max(iters // 10, 1), device, trainer=trainer,
                seed=seed, fig_dir=fig_dir)


def realnvp(iters, device, fig_dir=None, seed=123):
    return _realnvp("realnvp_banana_hard", iters, device, fig_dir, seed)


def realnvp_fused(iters, device, fig_dir=None, seed=123):
    """The RealNVP row's recipe through `realnvp(fused=True)`: one K4 and
    one K5 a step."""
    return _realnvp("realnvp_banana_hard_fused", iters, device, fig_dir, seed,
                    fused=True)


def realnvp_k6(iters, device, fig_dir=None, seed=123):
    """The RealNVP row's recipe through `train_realnvp_fused`: K6 in
    launches of 512 steps."""
    return _realnvp("realnvp_banana_hard_k6", iters, device, fig_dir, seed,
                    k6=True)


def nsf(iters, device, fig_dir=None, seed=123):
    """`example/demo_neural_spline_flow.jl:20-53`: hard Banana(2,1,100),
    f32, defaults (10 layers, [32,32], K=10, B=30), 64 samples/iter,
    elbo_batch, with the trainable affine envelope (``affine_wrap=True``),
    identity init and Adam under warmup-cosine (peak 5e-4, 500 warmup
    steps, down to 1e-5 at the last step), as the JAX row."""
    t = nft.Banana(2, 1.0, 100.0)
    flow = nft.nsf(torch.Generator().manual_seed(0), 2, identity_init=True,
                   affine_wrap=True, device=device)
    sched = nft.optim.warmup_cosine_decay_schedule(
        0.0, 5e-4, warmup_steps=500, decay_steps=iters, end_value=1e-5)
    return _run("nsf_banana_hard", flow, t.log_prob,
                _target_sampler(t, torch.float32), nft.elbo_batch, 64,
                nft.optim.adam(sched), iters, max(iters // 10, 1), device,
                eval_reps=4, seed=seed, fig_dir=fig_dir)


def hamiltonian(iters, device, fig_dir=None, seed=123):
    """`example/demo_hamiltonian_flow.jl:105-171`: Funnel(2,−8,5), f64,
    15 blocks × 3 leapfrog, ϵ₀=0.05, per-sample elbo on the joint space,
    16 samples/iter, Adam(3e-4); the x block's moments."""
    dtype = torch.float64
    dim = 2
    t = nft.Funnel(dim, -8.0, 5.0)
    flow = nft.hamiltonian_flow(dim, t.score, n_blocks=15, L=3, eps0=0.05,
                                dtype=dtype, device=device)
    lp = joint_logp(t.log_prob, dim)
    # the funnel's score is analytic: the evaluations run under no_grad
    return _run("hamiltonian_funnel", flow, lp, _target_sampler(t, dtype),
                nft.elbo, 16, nft.optim.adam(3e-4), iters,
                max(iters // 10, 1), device, project=lambda s: s[:, :dim],
                n_eval=65536, eval_reps=8, seed=seed, fig_dir=fig_dir)


def _run_mle(name, flow, target, batch, optimizer, max_iters, check_every,
             device, n_train=65536, seed=123, fig_dir=None):
    """`benchmarks/parity.py`'s `_run_mle` on the port: `train_flow_mle`
    on exact target draws (a `NumpyLoader` over the array, as the JAX
    harness's `make_loader(array)`), scored by the held-out mean
    log-likelihood, with the same sample evidence."""
    untrained = copy.deepcopy(flow)
    train_data = target.sample(_gen(device, seed), (n_train,))
    heldout = target.sample(_gen(device, seed + 1), (N_EVAL,))
    loader = make_loader(train_data.cpu().numpy(), batch, seed=seed)

    def ll(f):
        with torch.no_grad():
            return float(nft.loglikelihood(f, heldout))

    before = ll(flow)
    t0 = time.perf_counter()
    res = nft.train_flow_mle(flow, loader, max_iters=max_iters,
                             optimizer=optimizer, check_every=check_every)
    after = ll(res.flow)
    wall = time.perf_counter() - t0
    loader.close()
    tail = res.stats["loss"][-max(max_iters // 10, 1):]
    evidence, samples = _sample_moments(
        res.flow, untrained, _target_sampler(target, torch.float32), None,
        device)
    return {
        "workload": name,
        "metric": "heldout_mean_loglik (forward-KL MLE; other rows: ELBO)",
        "iters": int(max_iters),
        "elbo_before": round(before, 4),
        "elbo_after": round(after, 4),
        "elbo_train_tail": round(-float(sum(tail) / len(tail)), 4),
        "iters_per_s": round(max_iters / wall, 1),
        **evidence,
        "figure": _figure(fig_dir, name, *samples),
        "improved_significant": bool(after > before),
        "device": _device_name(device),
    }


def glow_w(iters, device, fig_dir=None, seed=123):
    """Glow on the Cross target (`examples/demo_glow.py`: 6 blocks
    [32,32], data-dependent ActNorm init from 1,024 base draws, 64
    samples/iter, Adam(2e-3))."""
    t = nft.Cross(device=device)
    flow = nft.glow(torch.Generator().manual_seed(0), 2, (32, 32),
                    nlayers=6, device=device)
    with torch.no_grad():
        flow = nft.glow_init_actnorms(flow, flow.base.sample(
            _gen(device, 1), (1024,)))
    return _run("glow_cross", flow, t.log_prob,
                _target_sampler(t), nft.elbo_batch, 64,
                nft.optim.adam(2e-3), iters, max(iters // 10, 1), device,
                eval_reps=4, seed=seed, fig_dir=fig_dir)


def iaf_w(iters, device, fig_dir=None, seed=123):
    """IAF reverse-KL on the easy Banana(2,1,10): 5 layers [32,32], 64
    samples/iter, Adam(2e-3)."""
    t = nft.Banana(2, 1.0, 10.0)
    flow = nft.iaf(torch.Generator().manual_seed(0), 2, (32, 32), nlayers=5,
                   device=device)
    return _run("iaf_banana_easy", flow, t.log_prob,
                _target_sampler(t, torch.float32), nft.elbo_batch, 64,
                nft.optim.adam(2e-3), iters, max(iters // 10, 1), device,
                seed=seed, fig_dir=fig_dir)


def maf_w(iters, device, fig_dir=None, seed=123):
    """MAF forward-KL MLE on exact Banana(2,1,10) draws
    (`examples/demo_maf_mle.py`: 5 layers [32,32], batch 256, Adam(1e-3))."""
    t = nft.Banana(2, 1.0, 10.0)
    flow = nft.maf(torch.Generator().manual_seed(0), 2, (32, 32), nlayers=5,
                   device=device)
    return _run_mle("maf_banana_mle", flow, t, 256, nft.optim.adam(1e-3),
                    iters, max(iters // 10, 1), device, seed=seed,
                    fig_dir=fig_dir)


# name: (function, full steps, quick steps), benchmarks/parity.py:374-395,
# and the two kernel routes of the RealNVP row at its counts
WORKLOADS = {
    "planar": (planar, 10_000, 500),
    "radial": (radial, 10_000, 500),
    "realnvp": (realnvp, 50_000, 2_000),
    "realnvp_fused": (realnvp_fused, 50_000, 2_000),
    "realnvp_k6": (realnvp_k6, 50_000, 2_000),
    "nsf": (nsf, 50_000, 1_000),
    "hamiltonian": (hamiltonian, 20_000, 100),
    "glow": (glow_w, 10_000, 500),
    "iaf": (iaf_w, 10_000, 500),
    "maf": (maf_w, 3_000, 300),
}
# the JAX row each port row is held against
JAX_ROW = {"realnvp_banana_hard_fused": "realnvp_banana_hard",
           "realnvp_banana_hard_k6": "realnvp_banana_hard"}


def band(row: dict, ref: dict) -> dict:
    """The pass band of a port row against its JAX row: pass when the
    port's final value is no lower than the JAX row's less the larger of
    BAND_NATS and BAND_SEMS times the two SEMs added together."""
    sems = (row.get("elbo_after_sem") or 0.0) + (ref.get("elbo_after_sem")
                                                  or 0.0)
    width = max(BAND_NATS, BAND_SEMS * sems)
    return {"port": row["elbo_after"], "port_sem": row.get("elbo_after_sem"),
            "jax": ref["elbo_after"], "jax_sem": ref.get("elbo_after_sem"),
            "band": width, "iters": row["iters"], "jax_iters": ref["iters"],
            "pass": bool(row["elbo_after"] >= ref["elbo_after"] - width)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="all",
                   help="one of %s, 'all', or a comma-separated list"
                        % ", ".join(WORKLOADS))
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--quick", action="store_true",
                   help="CI-speed iteration counts")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--out", default=None,
                   help="JSON file for the rows and their bands")
    p.add_argument("--reference", default=str(REFERENCE),
                   help="the JAX harness's rows (read only)")
    a = p.parse_args(argv)

    names = list(WORKLOADS) if a.workload == "all" else a.workload.split(",")
    unknown = [n for n in names if n not in WORKLOADS]
    if unknown:
        p.error(f"unknown workload(s): {unknown}")
    device = resolve_device(a.device)
    reference = json.loads(Path(a.reference).read_text())
    out = Path(a.out) if a.out else None
    fig_dir = out.parent / "figures" if out else None
    rows, bands = {}, {}
    for name in names:
        fn, full, quick = WORKLOADS[name]
        row = fn(a.iters or (quick if a.quick else full), device, fig_dir)
        rows[name] = row
        bands[name] = band(row, reference[JAX_ROW.get(row["workload"],
                                                      row["workload"])])
        print(json.dumps(row), flush=True)
        print(json.dumps({"band": {name: bands[name]}}), flush=True)
        if out:  # after every row: a long run keeps what it has
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps({"rows": rows, "bands": bands},
                                      indent=1))
    return rows, bands


if __name__ == "__main__":
    main()
