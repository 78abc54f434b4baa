"""Two parity rows' recipes in both packages on the same draws (CPU).

The RealNVP row (float32) and the Hamiltonian row (float64) of
`benchmarks/parity.py` from their init (the port's flow a copy of JAX's),
trained in one chunk of ``steps`` Adam steps on one set of numpy draws by
JAX `train_flow` and the port's, then scored on 65,536 common numpy draws
(the ELBO of each package's flow by its own `elbo_from_samples`).
`tests/test_torch_examples.py` holds the first 200 steps step for step; run
as a script, it trains a whole row and prints both packages' final ELBOs,
which says whether a row's miss on the card is the port's or the draws':

    python tests/_parity_shared_draws.py --workload realnvp --steps 50000 \\
        --seed 1

It imports JAX, so it runs where the tests run (JAX on the CPU), not on
the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.models.hamiltonian import (  # noqa: E402
    joint_logp as jax_joint_logp,
)
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.models.hamiltonian import joint_logp  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

EVAL_DRAWS = 65536


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def row_recipe(name):
    """(JAX flow, the port's flow with JAX's init, JAX log-density, the
    port's, batch, rate, draws' dimension and dtype) of a row."""
    if name == "realnvp":
        jflow = nf.realnvp(jax.random.key(0), 2, (16, 16), nlayers=3)
        tflow = nft.realnvp(torch.Generator().manual_seed(0), 2, (16, 16),
                            nlayers=3, device="cpu")
        return (jflow, load_jax_params(tflow, jax_arrays(jflow)),
                nf.Banana(2, 1.0, 100.0).log_prob,
                nft.Banana(2, 1.0, 100.0).log_prob, 16, 5e-4, 2, np.float32)
    if name != "hamiltonian":
        raise ValueError(f"no recipe for {name!r}")
    jt, tt = nf.Funnel(2, -8.0, 5.0), nft.Funnel(2, -8.0, 5.0)
    jflow = nf.hamiltonian_flow(2, jt.score, n_blocks=15, L=3, eps0=0.05,
                                dtype=jnp.float64)
    tflow = nft.hamiltonian_flow(2, tt.score, n_blocks=15, L=3, eps0=0.05,
                                 dtype=torch.float64, device="cpu")
    return (jflow, tflow, jax_joint_logp(jt.log_prob, 2),
            joint_logp(tt.log_prob, 2), 16, 3e-4, 4, np.float64)


def train_both(name, steps, seed):
    """Both packages' TrainResults after ``steps`` steps in one chunk on
    the draws of numpy seed ``seed`` (one chunk: JAX traces
    ``scan_inputs`` once, so its draws are a constant of the compiled
    chunk), and the recipe."""
    recipe = row_recipe(name)
    jflow, tflow, jlp, tlp, batch, lr, dim, dt = recipe
    draws = np.random.default_rng(seed).standard_normal(
        (steps, batch, dim)).astype(dt)
    jres = nf.train_flow(
        jax.random.key(0), lambda xs, f, lp: nf.elbo_from_samples(xs, f, lp),
        jflow, jlp, max_iters=steps, check_every=steps,
        optimizer=optax.adam(lr),
        scan_inputs=lambda k, f, n: jnp.asarray(draws))
    res = nft.train_flow(
        torch.Generator(), nft.elbo_from_samples, tflow, tlp, max_iters=steps,
        check_every=steps, optimizer=nft.optim.adam(lr),
        scan_inputs=lambda g, f, n: torch.from_numpy(draws))
    return jres, res, recipe


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", choices=("realnvp", "hamiltonian"),
                   required=True)
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    jres, res, (_, _, jlp, tlp, _, _, dim, dt) = train_both(
        a.workload, a.steps, a.seed)
    ev = np.random.default_rng(99).standard_normal(
        (EVAL_DRAWS, dim)).astype(dt)
    jax_elbo = float(nf.elbo_from_samples(jnp.asarray(ev), jres.flow, jlp))
    with torch.no_grad():
        port_elbo = float(nft.elbo_from_samples(torch.from_numpy(ev),
                                                res.flow, tlp))
    a_, b_ = res.stats["loss"], np.asarray(jres.stats["loss"])
    k = max(a.steps // 10, 1)
    rel = np.abs(a_ - b_) / np.maximum(np.abs(b_), 1e-30)
    print(json.dumps({
        "workload": a.workload, "steps": a.steps, "seed": a.seed,
        "jax_elbo": jax_elbo, "port_elbo": port_elbo,
        "jax_train_tail": -float(b_[-k:].mean()),
        "port_train_tail": -float(a_[-k:].mean()),
        "first_step_apart_1e-3": (int(np.argmax(rel > 1e-3))
                                  if (rel > 1e-3).any() else None),
        "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
