"""The port's Hamiltonian flow against the JAX package's.

`LeapFrog` forward and inverse (the inverse negates ε) with its zero
log-det; `momentum_normalization_layer`; `hamiltonian_flow` in the JAX
default layout (``scan=True``, loaded through the weight bridge) and as a
`Chain` of blocks (``scan=False``): the round trip, and the ELBO on the
joint space with its gradients, for `Funnel.score` (closed form: a first
order backward) and for `Banana.score` (autograd: a double backward); 5
Adam steps of `train_flow` on the same presampled draws.

Tolerances: f64 rtol 1e-9 (atol 1e-12); f32 rtol 1e-5 (atol 1e-6) for
values and ELBOs, 1e-4 relative (atol 1e-6) for gradients, the round trip
rtol 1e-4 (atol 1e-5); the Adam steps `tests/test_torch_train.py`'s f64
rtol 1e-8 (atol 1e-12) and f32 rtol 1e-4 (atol 1e-5).
"""

import copy

import numpy as np
import optax
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.models.hamiltonian import (  # noqa: E402
    joint_logp as jax_joint_logp,
)
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.models.hamiltonian import joint_logp  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": (1e-5, 1e-6), "f64": (1e-9, 1e-12)}
GRAD_TOL = {"f32": (1e-4, 1e-6), "f64": (1e-9, 1e-12)}
ROUND_TRIP_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-9, 1e-12)}
TRAIN_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-8, 1e-12)}
DIM, BLOCKS, L, N, LR, STEPS = 2, 3, 3, 16, 3e-3, 5


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol[0], atol=tol[1], err_msg=msg)


def _close_params(tflow, jtree, tol, grads=False):
    ref = dict(load_jax_params(copy.deepcopy(tflow),
                               jax_arrays(jtree)).named_parameters())
    for name, p in tflow.named_parameters():
        got = p.grad if grads else p
        _close(got.detach().numpy(), ref[name].detach().numpy(), tol, name)


def _targets(name):
    """(JAX target, the port's): the demo's funnel or the easy banana."""
    if name == "funnel":
        return nf.Funnel(DIM, -8.0, 5.0), nft.Funnel(DIM, -8.0, 5.0)
    return nf.Banana(DIM, 1.0, 10.0), nft.Banana(DIM, 1.0, 10.0)


def _perturbed(jflow, seed):
    """Every leaf moved by noise of 0.05, so that no scale is 1, no shift
    0 and the step sizes differ between dimensions and blocks."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.asarray(rng.standard_normal(a.shape),
                                         a.dtype), jflow)


def _flows(name, dt, scan=True, seed=0):
    jdt, tdt, _ = DT[dt]
    jt, tt = _targets(name)
    jflow = _perturbed(nf.hamiltonian_flow(DIM, jt.score, BLOCKS, L, 0.05,
                                           jdt, scan=scan), seed)
    if scan:
        tflow = nft.hamiltonian_flow(DIM, tt.score, BLOCKS, L, 0.05, tdt,
                                     device="cpu")
    else:
        tflow = nft.create_flow(
            [nft.Scale(torch.ones(2 * DIM, dtype=tdt)),
             nft.Shift(torch.zeros(2 * DIM, dtype=tdt))]
            + [nft.chain(nft.LeapFrog.make(DIM, np.log(0.05), L, tt.score,
                                           tdt, "cpu"),
                         nft.momentum_normalization_layer(DIM, tdt, "cpu"))
               for _ in range(BLOCKS)],
            nft.DiagNormal.standard(2 * DIM, tdt, device="cpu"))
    return jflow, load_jax_params(tflow, jax_arrays(jflow)), jt, tt


def _z(dt, n=N, seed=3):
    return (0.7 * np.random.default_rng(seed).standard_normal(
        (n, 2 * DIM))).astype(DT[dt][2])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_leapfrog_matches_jax(dt):
    jdt, tdt, _ = DT[dt]
    jt, tt = _targets("funnel")
    log_eps = np.log([0.05, 0.08]).astype(DT[dt][2])
    jl = nf.LeapFrog(jnp.asarray(log_eps), DIM, L, jt.score)
    tl = nft.LeapFrog(torch.from_numpy(log_eps), DIM, L, tt.score)
    assert [n for n, _ in tl.named_parameters()] == ["log_eps"]
    z = _z(dt)
    for way in ("forward_and_log_det", "inverse_and_log_det"):
        jy, jld = jax.jit(getattr(jl, way))(jnp.asarray(z))
        with torch.no_grad():
            ty, tld = getattr(tl, way)(torch.from_numpy(z))
        _close(ty.numpy(), jy, TOL[dt], way)
        assert np.all(tld.numpy() == 0) and np.all(np.asarray(jld) == 0)
    with torch.no_grad():
        back = tl.inverse(tl(torch.from_numpy(z)))
    _close(back.numpy(), z, ROUND_TRIP_TOL[dt])


def test_momentum_layer_and_joint_logp_match_jax():
    ml = nft.momentum_normalization_layer(DIM, torch.float64, "cpu")
    assert isinstance(ml, nft.Stacked) and ml.spans
    assert ml.index_sets == ((0, 1), (2, 3))
    jml = _perturbed(nf.momentum_normalization_layer(DIM, jnp.float64), 1)
    load_jax_params(ml, jax_arrays(jml))
    z = _z("f64")
    for way in ("forward_and_log_det", "inverse_and_log_det"):
        jy, jld = getattr(jml, way)(jnp.asarray(z))
        with torch.no_grad():
            ty, tld = getattr(ml, way)(torch.from_numpy(z))
        _close(ty.numpy(), jy, TOL["f64"])
        _close(tld.numpy(), jld, TOL["f64"])
    jt, tt = _targets("funnel")
    _close(joint_logp(tt.log_prob, DIM)(torch.from_numpy(z)).numpy(),
           jax_joint_logp(jt.log_prob, DIM)(jnp.asarray(z)), TOL["f64"])


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("scan", [True, False])
def test_flow_and_round_trip_match_jax(scan, dt):
    jflow, tflow, _, _ = _flows("funnel", dt, scan=scan)
    rep = tflow.bijector.bijectors[2]
    assert isinstance(rep, nft.Repeated) == scan
    z = _z(dt)
    jy, jld = jax.jit(jflow.bijector.forward_and_log_det)(jnp.asarray(z))
    with torch.no_grad():
        ty, tld = tflow.bijector.forward_and_log_det(torch.from_numpy(z))
        back, ild = tflow.bijector.inverse_and_log_det(ty)
    _close(ty.numpy(), jy, TOL[dt])
    _close(tld.numpy(), jld, TOL[dt])
    _close(back.numpy(), z, ROUND_TRIP_TOL[dt])
    _close((tld + ild).numpy(), np.zeros(len(z)), (0, ROUND_TRIP_TOL[dt][0]))
    lp = tflow.log_prob(ty)
    _close(lp.detach().numpy(), jax.jit(jflow.log_prob)(jnp.asarray(jy)),
           TOL[dt])


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("target", ["funnel", "banana"])
def test_elbo_and_its_gradients_match_jax(target, dt):
    """On the joint space; with Banana's autograd score the gradient is a
    double backward through the leapfrog steps."""
    jflow, tflow, jt, tt = _flows(target, dt, seed=2)
    xs = _z(dt, seed=4) / 0.7
    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda f: nf.elbo_from_samples(jnp.asarray(xs), f,
                                       jax_joint_logp(jt.log_prob, DIM))))(
        jflow)
    val = nft.elbo_from_samples(torch.from_numpy(xs), tflow,
                                joint_logp(tt.log_prob, DIM))
    _close(val.detach().numpy(), jval, TOL[dt])
    val.backward()
    _close_params(tflow, jgrads, GRAD_TOL[dt], grads=True)


def _jax_objective(xs, flow, logp, n):
    return nf.elbo_from_samples(xs, flow, logp)


def _port_objective(xs, flow, logp, n):
    return nft.elbo_from_samples(xs, flow, logp)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_train_flow_matches_jax(dt):
    """5 Adam steps of the funnel demo's flow (3 blocks), base frozen."""
    jflow, tflow, jt, tt = _flows("funnel", dt)
    draws = np.random.default_rng(5).standard_normal(
        (STEPS, N, 2 * DIM)).astype(DT[dt][2])
    jres = nf.train_flow(
        jax.random.key(0), _jax_objective, jflow,
        jax_joint_logp(jt.log_prob, DIM), N, max_iters=STEPS,
        check_every=STEPS, optimizer=optax.adam(LR),
        scan_inputs=lambda k, f, n: jnp.asarray(draws))
    res = nft.train_flow(
        torch.Generator(), _port_objective, tflow,
        joint_logp(tt.log_prob, DIM), N, max_iters=STEPS, check_every=STEPS,
        optimizer=lambda p: torch.optim.Adam(p, lr=LR),
        scan_inputs=lambda g, f, n: torch.from_numpy(draws))
    _close(res.stats["loss"], jres.stats["loss"], TRAIN_TOL[dt])
    _close_params(tflow, jres.flow, TRAIN_TOL[dt])


def test_hamiltonian_flow_layout():
    """The JAX default's leaves, and what the port's module holds: the
    score is a plain attribute, so the target is no submodule."""
    jflow, tflow, _, tt = _flows("funnel", "f64")
    assert set(jax_arrays(jflow)) == {
        ".base.loc", ".base.scale", ".bijector.bijectors[0].a",
        ".bijector.bijectors[1].b",
        ".bijector.bijectors[2].stacked.bijectors[0].log_eps",
        ".bijector.bijectors[2].stacked.bijectors[1].bijectors[1]"
        ".bijectors[0].a",
        ".bijector.bijectors[2].stacked.bijectors[1].bijectors[1]"
        ".bijectors[1].b"}
    rep = tflow.bijector.bijectors[2]
    assert rep.n == BLOCKS
    leap = rep.stacked[0].bijectors[0]
    assert leap.score_fn == tt.score and leap.L == L
    assert not any(isinstance(m, nft.Funnel) for m in tflow.modules())
    assert tflow.event_dim == 2 * DIM
