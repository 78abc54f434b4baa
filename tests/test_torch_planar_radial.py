"""The port's planar and radial flows and their root solver against the
JAX package's.

`solve_monotone`: the root and its implicit gradient against JAX
`lax.custom_root`, also where the parameters enter only through ``f``.
Flows (4 layers, the JAX default ``scan=True`` layout loaded through the
weight bridge, and the ``scan=False`` layout as a `Chain`): forward,
log-det and inverse; the round trip; `log_prob` and its gradient (through
the inverse, so through the solver); the ELBO and its gradients; 5 Adam
steps of `train_flow` on the same presampled draws.

Tolerances: f64 rtol 1e-9 (atol 1e-12) throughout; f32 rtol 1e-5 (atol
1e-6) for values, log-dets and ELBOs, 1e-4 relative (atol 1e-6) for
gradients, the round trip rtol 1e-4 (atol 1e-5; `tests/test_flows.py:5`),
and the 5 Adam steps `tests/test_torch_train.py`'s rtol 1e-4 (atol 1e-5,
f64 1e-8 and 1e-12): Adam's normalised steps carry the last bits along.
The draws keep off radial's centre z₀, where ‖x − z₀‖ has no gradient in
either package.
"""

import copy

import numpy as np
import optax
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.ops.solvers import (  # noqa: E402
    solve_monotone as jax_solve,
)
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.ops.solvers import solve_monotone  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": (1e-5, 1e-6), "f64": (1e-9, 1e-12)}
GRAD_TOL = {"f32": (1e-4, 1e-6), "f64": (1e-9, 1e-12)}
ROUND_TRIP_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-9, 1e-12)}
TRAIN_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-8, 1e-12)}
NLAYERS, N, LR, STEPS = 4, 32, 1e-2, 5


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol[0], atol=tol[1], err_msg=msg)


def _close_params(tflow, jtree, tol, grads=False):
    """Each of ``tflow``'s parameters (or their gradients) against the
    same leaf of the JAX pytree ``jtree``, matched by the weight bridge."""
    ref = dict(load_jax_params(copy.deepcopy(tflow),
                               jax_arrays(jtree)).named_parameters())
    for name, p in tflow.named_parameters():
        got = p.grad if grads else p
        _close(got.detach().numpy(), ref[name].detach().numpy(), tol, name)


# --------------------------------------------------------------------------
# solve_monotone
# --------------------------------------------------------------------------

def _planar_like(lib, c, rhs):
    """a + c·tanh(a) = rhs: lo and hi depend on the parameters too."""
    tanh = jnp.tanh if lib is jnp else torch.tanh
    absc = jnp.abs(c) if lib is jnp else c.abs()

    def f(a):
        return a + c * tanh(a) - rhs

    return f, rhs - absc, rhs + absc


def _cubic(lib, theta, t):
    """a³ + θ·a = t on the fixed bracket [−10, 10]: θ and t enter only
    through f."""
    def f(a):
        return a * a * a + theta * a - t

    full_like = jnp.full_like if lib is jnp else torch.full_like
    return f, full_like(t, -10.0), full_like(t, 10.0)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("problem", ["planar_like", "cubic"])
def test_solve_monotone_matches_custom_root(problem, dt):
    jdt, tdt, ndt = DT[dt]
    rng = np.random.default_rng(2)
    if problem == "planar_like":
        p1 = np.asarray(0.6, ndt)
        p2 = (2.0 * rng.standard_normal(7)).astype(ndt)
        make = _planar_like
    else:
        p1 = rng.uniform(0.5, 2.0, 7).astype(ndt)
        p2 = (3.0 * rng.standard_normal(7)).astype(ndt)
        make = _cubic
    w = rng.standard_normal(7).astype(ndt)

    def jloss(a, b):
        root = jax_solve(*make(jnp, a, b))
        return jnp.sum(root * w), root

    (_, jroot), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(p1),
                                              jnp.asarray(p2))
    t1 = torch.from_numpy(p1).requires_grad_(True)
    t2 = torch.from_numpy(p2).requires_grad_(True)
    f, lo, hi = make(torch, t1, t2)
    root = solve_monotone(f, lo, hi)
    assert root.dtype == tdt
    _close(root.detach().numpy(), jroot, TOL[dt])
    # f(root) = 0 to the dtype's precision
    _close(f(root).detach().numpy(), np.zeros_like(w),
           (0, {"f32": 1e-4, "f64": 1e-12}[dt]))
    (root * torch.from_numpy(w)).sum().backward()
    for got, want in zip((t1.grad, t2.grad), jgrads):
        assert got is not None  # the gradient reaches f's closure
        _close(got.numpy(), want, GRAD_TOL[dt])


def test_solve_monotone_value_is_the_root_and_no_grad_builds_no_graph():
    theta = torch.tensor([1.0, 2.0], dtype=torch.float64, requires_grad=True)
    t = torch.tensor([0.5, -3.0], dtype=torch.float64)
    f, lo, hi = _cubic(torch, theta, t)
    with_grad = solve_monotone(f, lo, hi)
    with torch.no_grad():
        without = solve_monotone(f, lo, hi)
    assert with_grad.requires_grad and not without.requires_grad
    assert torch.equal(with_grad.detach(), without)


# --------------------------------------------------------------------------
# planar and radial flows
# --------------------------------------------------------------------------

def _flows(kind, dt, seed=0, scan=True):
    """The JAX flow (4 layers on a standard normal) and the port's copy:
    `planarflow`/`radialflow` for ``scan=True``, a `Chain` of layers for
    JAX's ``scan=False``."""
    jdt, tdt, _ = DT[dt]
    jmake = nf.planarflow if kind == "planar" else nf.radialflow
    jflow = jmake(jax.random.key(seed), nf.DiagNormal.standard(2, jdt),
                  NLAYERS, jdt, scan=scan)
    g = torch.Generator().manual_seed(seed)
    if scan:
        tmake = nft.planarflow if kind == "planar" else nft.radialflow
        tflow = tmake(g, 2, NLAYERS, tdt, device="cpu")
    else:
        layer = nft.PlanarLayer if kind == "planar" else nft.RadialLayer
        tflow = nft.create_flow(
            [layer.make(g, 2, tdt, "cpu") for _ in range(NLAYERS)],
            nft.DiagNormal.standard(2, tdt, device="cpu"))
    return jflow, load_jax_params(tflow, jax_arrays(jflow))


def _target(kind, dt):
    if kind == "planar":
        return nf.Banana(2, 1.0, 10.0), nft.Banana(2, 1.0, 10.0)
    return nf.WarpedGauss(1.0, 0.12), nft.WarpedGauss(1.0, 0.12)


def _x(dt, n=N, seed=7):
    return (1.5 * np.random.default_rng(seed).standard_normal((n, 2))
            ).astype(DT[dt][2])


KINDS = [("planar", True), ("radial", True), ("planar", False),
         ("radial", False)]


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind,scan", KINDS)
def test_forward_inverse_and_log_det_match_jax(kind, scan, dt):
    jflow, tflow = _flows(kind, dt, scan=scan)
    rep = tflow.bijector.bijectors[0]
    assert isinstance(rep, nft.Repeated) == scan
    x = _x(dt)
    for way in ("forward_and_log_det", "inverse_and_log_det"):
        jy, jld = jax.jit(getattr(jflow.bijector, way))(jnp.asarray(x))
        with torch.no_grad():
            ty, tld = getattr(tflow.bijector, way)(torch.from_numpy(x))
        assert ty.dtype == DT[dt][1]
        _close(ty.numpy(), jy, TOL[dt], way)
        _close(tld.numpy(), jld, TOL[dt], way)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["planar", "radial"])
def test_round_trip(kind, dt):
    """inverse(forward(x)) = x and the log-dets cancel."""
    _, tflow = _flows(kind, dt, seed=3)
    x = torch.from_numpy(_x(dt, n=256, seed=8))
    with torch.no_grad():
        y, ld = tflow.bijector.forward_and_log_det(x)
        back, ild = tflow.bijector.inverse_and_log_det(y)
    _close(back.numpy(), x.numpy(), ROUND_TRIP_TOL[dt])
    _close((ld + ild).numpy(), np.zeros(len(x)), (0, ROUND_TRIP_TOL[dt][0]))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["planar", "radial"])
def test_log_prob_and_its_gradient_match_jax(kind, dt):
    """The density path: the inverse through the solver, whose implicit
    gradient reaches every layer's parameters and the base's."""
    jflow, tflow = _flows(kind, dt)
    y = _x(dt, seed=9)

    def jloss(f):
        lp = f.log_prob(jnp.asarray(y))
        return jnp.mean(lp), lp

    (_, jlp), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jflow)
    lp = tflow.log_prob(torch.from_numpy(y))
    _close(lp.detach().numpy(), jlp, TOL[dt])
    lp.mean().backward()
    _close_params(tflow, jgrads, GRAD_TOL[dt], grads=True)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["planar", "radial"])
def test_elbo_and_its_gradients_match_jax(kind, dt):
    jflow, tflow = _flows(kind, dt)
    jt, tt = _target(kind, dt)
    xs = np.random.default_rng(10).standard_normal((N, 2)).astype(
        DT[dt][2])
    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda f: nf.elbo_from_samples(jnp.asarray(xs), f, jt.log_prob)))(
        jflow)
    val = nft.elbo_from_samples(torch.from_numpy(xs), tflow, tt.log_prob)
    _close(val.detach().numpy(), jval, TOL[dt])
    val.backward()
    _close_params(tflow, jgrads, GRAD_TOL[dt], grads=True)


def _jax_objective(xs, flow, logp, n):
    return nf.elbo_from_samples(xs, flow, logp)


def _port_objective(xs, flow, logp, n):
    return nft.elbo_from_samples(xs, flow, logp)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["planar", "radial"])
def test_train_flow_matches_jax(kind, dt):
    """5 Adam steps of `train_flow` (base frozen) on the same draws."""
    jflow, tflow = _flows(kind, dt)
    jt, tt = _target(kind, dt)
    draws = np.random.default_rng(11).standard_normal((STEPS, N, 2)).astype(
        DT[dt][2])
    jres = nf.train_flow(
        jax.random.key(0), _jax_objective, jflow, jt.log_prob, N,
        max_iters=STEPS, check_every=STEPS, optimizer=optax.adam(LR),
        scan_inputs=lambda k, f, n: jnp.asarray(draws))
    res = nft.train_flow(
        torch.Generator(), _port_objective, tflow, tt.log_prob, N,
        max_iters=STEPS, check_every=STEPS,
        optimizer=lambda p: torch.optim.Adam(p, lr=LR),
        scan_inputs=lambda g, f, n: torch.from_numpy(draws))
    _close(res.stats["loss"], jres.stats["loss"], TRAIN_TOL[dt])
    assert res.flow is tflow
    _close_params(tflow, jres.flow, TRAIN_TOL[dt])


def test_constructors_default_to_the_card():
    for make in (nft.planarflow, nft.radialflow):
        if torch.cuda.is_available():
            flow = make(torch.Generator(), 2, 3)
            assert all(p.is_cuda for p in flow.parameters())
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(torch.Generator(), 2, 3)
