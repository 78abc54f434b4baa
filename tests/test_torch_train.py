"""The port's `train_flow` against the JAX package's training step.

5 Adam steps on identical presampled base draws: JAX `optax.adam` with
`jax.value_and_grad` of −`elbo_from_samples` and the base masked out, as
bench.py's `make_train_chunk` runs it, against the port's `train_flow` fed
the same draws through ``scan_inputs``. Plus the chunk driver's behaviour
(stats, callback, `hasconverged`, resume) and the frozen base.

Tolerances: f64 rtol 1e-8 (atol 1e-12) on per-step losses and final
parameters — same math, libraries' exp/log and sum orders differ in the last
bits, and Adam's normalised steps carry those differences along. f32 rtol
1e-4 (atol 1e-5): the same at f32 precision.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.utils.pytree import (  # noqa: E402
    apply_mask,
    trainable_mask,
)
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

DIM, HDIMS, NLAYERS, BATCH, LR, STEPS = 4, (16, 16), 2, 32, 5e-4, 5
DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": (1e-4, 1e-5), "f64": (1e-8, 1e-12)}


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _flows(dt, backend="oracle", seed=0):
    """An identity-initialised JAX nsf moved off the identity by noise of
    0.1 on every parameter, and the port's copy of it."""
    jdt, tdt, _ = DT[dt]
    jflow = nf.nsf(jax.random.key(seed), DIM, HDIMS, K=10, B=4.0,
                   nlayers=NLAYERS, dtype=jdt, backend=backend,
                   interpret=True, identity_init=True)
    rng = np.random.default_rng(seed + 1)
    jflow = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                        a.dtype), jflow)
    tflow = nft.nsf(torch.Generator().manual_seed(seed), DIM, HDIMS, K=10,
                    B=4.0, nlayers=NLAYERS, dtype=tdt, device="cpu")
    load_jax_params(tflow, jax_arrays(jflow))
    return jflow, tflow


def _jax_train(jflow, target, draws):
    """bench.py's `make_train_chunk` step, one jitted step per draw."""
    optimizer = optax.adam(LR)
    mask = trainable_mask(jflow, frozen=lambda m: m is jflow.base)

    @jax.jit
    def step(f, st, xs):
        loss, grads = jax.value_and_grad(
            lambda f: -nf.elbo_from_samples(xs, f, target.log_prob))(f)
        grads = apply_mask(grads, mask)
        updates, st = optimizer.update(grads, st, f)
        return optax.apply_updates(f, updates), st, loss

    st, losses = optimizer.init(jflow), []
    for xs in draws:
        jflow, st, loss = step(jflow, st, jnp.asarray(xs))
        losses.append(float(loss))
    return jflow, np.asarray(losses)


def _presampled(draws):
    """``scan_inputs`` handing train_flow the given draws, chunk by chunk."""
    draws = torch.from_numpy(draws)
    pos = [0]

    def gen(generator, flow, chunk):
        out = draws[pos[0]:pos[0] + chunk]
        pos[0] += chunk
        return out

    return gen


def _port_objective(xs, flow, logp):
    return nft.elbo_from_samples(xs, flow, logp)


def _adam(lr=LR):
    return lambda params: torch.optim.Adam(params, lr=lr)


@pytest.mark.parametrize("dt,backend", [("f64", "pallas"), ("f32", "oracle")])
def test_adam_steps_match_jax(dt, backend):
    jflow, tflow = _flows(dt, backend)
    draws = np.random.default_rng(7).standard_normal(
        (STEPS, BATCH, DIM)).astype(DT[dt][2])
    jflow, losses_j = _jax_train(jflow, nf.Banana(DIM, 1.0, 100.0), draws)

    target = nft.Banana(DIM, 1.0, 100.0)
    res = nft.train_flow(torch.Generator(), _port_objective, tflow,
                         target.log_prob, max_iters=STEPS, check_every=2,
                         optimizer=_adam(), scan_inputs=_presampled(draws))
    rtol, atol = TOL[dt]
    np.testing.assert_allclose(res.stats["loss"], losses_j, rtol=rtol,
                               atol=atol)
    ref = dict(load_jax_params(copy.deepcopy(tflow),
                               jax_arrays(jflow)).named_parameters())
    for name, p in res.flow.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def test_base_stays_frozen_unless_trained():
    _, tflow = _flows("f64")
    loc0 = tflow.base.loc.detach().clone()
    target = nft.Banana(DIM, 1.0, 100.0)
    g = torch.Generator().manual_seed(0)
    nft.train_flow(g, nft.elbo_batch, tflow, target.log_prob, BATCH,
                   max_iters=3, optimizer=_adam(1e-2))
    assert torch.equal(tflow.base.loc, loc0)
    assert not tflow.base.loc.requires_grad
    nft.train_flow(g, nft.elbo_batch, tflow, target.log_prob, BATCH,
                   max_iters=3, optimizer=_adam(1e-2), train_base=True)
    assert not torch.equal(tflow.base.loc, loc0)


def test_stats_callback_and_hasconverged_at_chunk_boundaries(capsys):
    _, tflow = _flows("f64")
    target = nft.Banana(DIM, 1.0, 100.0)
    seen = []

    def callback(it, stat, flow):
        seen.append((it, stat["loss"], stat["gradient_norm"]))
        assert flow is tflow
        return {"marker": it * 10}

    res = nft.train_flow(torch.Generator().manual_seed(1), nft.elbo_batch,
                         tflow, target.log_prob, BATCH, max_iters=7,
                         check_every=3, callback=callback,
                         optimizer=_adam(), show_progress=True)
    progress = capsys.readouterr().out.splitlines()
    assert [line.split()[2] for line in progress] == ["3", "6", "7"]
    assert all(line.startswith("[train_flow] iter") for line in progress)
    assert [s[0] for s in seen] == [3, 6, 7]
    np.testing.assert_array_equal(res.stats["iteration"], np.arange(1, 8))
    np.testing.assert_array_equal(res.stats["marker"], [30, 60, 70])
    assert res.stats["loss"].shape == res.stats["gradient_norm"].shape == (7,)
    assert np.all(np.isfinite(res.stats["loss"]))
    assert np.all(res.stats["gradient_norm"] > 0)
    # the callback saw each chunk's last step
    assert seen[-1][1] == res.stats["loss"][-1]
    assert seen[0][2] == res.stats["gradient_norm"][2]
    assert res.state.iteration == 7 and res.flow is tflow

    calls = []

    def hasconverged(it, stat, flow, opt_state):
        calls.append(it)
        assert isinstance(opt_state, torch.optim.Adam)
        return it >= 4

    res = nft.train_flow(torch.Generator().manual_seed(1), nft.elbo_batch,
                         tflow, target.log_prob, BATCH, max_iters=20,
                         check_every=2, hasconverged=hasconverged)
    assert calls == [2, 4] and len(res.stats["loss"]) == 4


def test_resume_continues_the_run_exactly():
    """3 steps then 3 resumed steps equal 6 straight steps (same chunking,
    same draws): the optimizer's moments and the step count carry over."""
    draws = np.random.default_rng(3).standard_normal((6, BATCH, DIM))
    target = nft.Banana(DIM, 1.0, 100.0)
    kw = dict(check_every=3, optimizer=_adam(1e-2))

    _, straight = _flows("f64")
    res = nft.train_flow(torch.Generator(), _port_objective, straight,
                         target.log_prob, max_iters=6,
                         scan_inputs=_presampled(draws), **kw)

    _, split = _flows("f64")
    gen = _presampled(draws)
    first = nft.train_flow(torch.Generator(), _port_objective, split,
                           target.log_prob, max_iters=3, scan_inputs=gen,
                           **kw)
    second = nft.train_flow(torch.Generator(), _port_objective, split,
                            target.log_prob, max_iters=3, scan_inputs=gen,
                            resume_state=first.state, **kw)
    np.testing.assert_array_equal(second.stats["iteration"], [4, 5, 6])
    np.testing.assert_array_equal(
        np.concatenate([first.stats["loss"], second.stats["loss"]]),
        res.stats["loss"])
    for a, b in zip(straight.parameters(), split.parameters()):
        assert torch.equal(a, b)


def test_optimize_minimises_over_all_parameters():
    class Quadratic(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(3, dtype=torch.float64))

    target = torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64)
    res = nft.optimize(torch.Generator(),
                       lambda g, m: ((m.w - target) ** 2).sum(), Quadratic(),
                       max_iters=400, optimizer=_adam(0.05),
                       check_every=100)
    np.testing.assert_allclose(res.flow.w.detach().numpy(), target.numpy(),
                               atol=1e-3)
    assert res.stats["loss"][-1] < 1e-6 < res.stats["loss"][0]
