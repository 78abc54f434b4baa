"""The port's MADE, MAF and IAF against the JAX package's.

`MaskedDense`/`MADE`: the degrees and masks equal JAX's, and the
autoregressive property holds (∂t_i/∂x_j = ∂s_i/∂x_j = 0 for j ≥ i, by
autograd). `Permute` and its inverse. `iaf`: forward (the parallel
direction), the ELBO and its gradients; `maf`: `log_prob`,
`loglikelihood` and their gradients (the parallel direction through
`Inverse`); both sequential directions against JAX and as round trips;
5 Adam steps of `train_flow` (IAF) and `train_flow_mle` (MAF) on the same
draws and batches.

Tolerances: f64 rtol 1e-9 (atol 1e-12); f32 rtol 1e-5 (atol 1e-5) for
values and log-dets, 1e-4 (atol 1e-5) for gradients and round trips
(`tests/test_flows.py`), the 5 Adam steps `tests/test_torch_train.py`'s
rtol 1e-4 (atol 1e-5; f64 1e-8, 1e-12).
"""

import copy

import numpy as np
import optax
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.models import autoregressive as jar  # noqa: E402
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.models import autoregressive as tar  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": (1e-5, 1e-5), "f64": (1e-9, 1e-12)}
GRAD_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-9, 1e-12)}
TRAIN_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-8, 1e-12)}
DIM, HDIMS, NLAYERS, N, LR, STEPS = 3, (8, 8), 3, 32, 1e-2, 5


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _close(got, want, tol, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol[0],
                               atol=tol[1], err_msg=msg)


def _close_params(tflow, jtree, tol, grads=False):
    ref = dict(load_jax_params(copy.deepcopy(tflow),
                               jax_arrays(jtree)).named_parameters())
    for name, p in tflow.named_parameters():
        _close(p.grad if grads else p, ref[name].detach().numpy(), tol, name)


def _perturb(jtree, seed=2, sigma=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + sigma * jnp.asarray(rng.standard_normal(a.shape),
                                          a.dtype), jtree)


def _x(dt, n=N, seed=7, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((n, DIM))
            ).astype(DT[dt][2])


def _flows(kind, dt, seed=0):
    """The JAX iaf/maf (perturbed, biases off 0) and the port's copy."""
    jdt, tdt, _ = DT[dt]
    jmake, tmake = (nf.iaf, nft.iaf) if kind == "iaf" else (nf.maf, nft.maf)
    jflow = _perturb(jmake(jax.random.key(seed), DIM, HDIMS, NLAYERS, jdt))
    tflow = tmake(torch.Generator(), DIM, HDIMS, NLAYERS, tdt, device="cpu")
    return jflow, load_jax_params(tflow, jax_arrays(jflow))


# --------------------------------------------------------------------------
# MADE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dim,hidden", [(1, (4,)), (2, (5, 3)),
                                        (3, (8, 8)), (5, (7,))])
def test_made_degrees_and_masks_match_jax(dim, hidden):
    jm = jar.MADE.make(jax.random.key(0), dim, hidden, dtype=jnp.float64)
    tm = tar.MADE.make(torch.Generator(), dim, hidden, dtype=torch.float64,
                       device="cpu")
    assert tm.dim == jm.dim == dim
    assert len(tm.layers) == len(jm.layers) == len(hidden) + 1
    for tl, jl in zip(tm.layers, jm.layers):
        assert tl.in_degrees == jl.in_degrees
        assert tl.out_degrees == jl.out_degrees
        assert tl.strict == jl.strict
        np.testing.assert_array_equal(tl.mask.numpy(),
                                      np.asarray(jl._mask(jnp.float64)))
    assert {n for n, _ in tm.named_buffers()} == {
        f"layers.{i}.mask" for i in range(len(hidden) + 1)}
    # a mask is made once, not per call, and is no JAX leaf
    assert not tm.layers[0]._buffers["mask"].requires_grad
    assert tm.layers[0]._non_persistent_buffers_set == {"mask"}


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_made_matches_jax_and_is_autoregressive(dt):
    jm = _perturb(jar.MADE.make(jax.random.key(1), DIM, HDIMS,
                                dtype=DT[dt][0]))
    tm = load_jax_params(tar.MADE.make(torch.Generator(), DIM, HDIMS,
                                       dtype=DT[dt][1], device="cpu"),
                         jax_arrays(jm))
    x = _x(dt)
    jt, js = jm(jnp.asarray(x))
    tt, ts = tm(torch.from_numpy(x))
    _close(tt, jt, TOL[dt])
    _close(ts, js, TOL[dt])
    # output i depends on x_j for j < i only
    jac = torch.autograd.functional.jacobian(
        lambda v: torch.cat(tm(v)), torch.from_numpy(x[0]))
    for head in (jac[:DIM], jac[DIM:]):
        assert not torch.triu(head).any()
        assert torch.tril(head, -1).abs().sum() > 0


@pytest.mark.parametrize("perm", [(2, 1, 0), (1, 3, 0, 2)])
def test_permute_and_its_inverse_match_jax(perm):
    x = np.random.default_rng(0).standard_normal((5, len(perm)))
    jp, tp = jar.Permute(perm), tar.Permute(perm, device="cpu")
    for way in ("forward_and_log_det", "inverse_and_log_det"):
        jy, jld = getattr(jp, way)(jnp.asarray(x))
        ty, tld = getattr(tp, way)(torch.from_numpy(x))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        assert not tld.any() and tld.shape == (5,)
    back = tp.inverse(tp(torch.from_numpy(x)))
    np.testing.assert_array_equal(back.numpy(), x)
    assert tar.Permute.reverse(4, "cpu").perm == (3, 2, 1, 0)
    assert {n for n, _ in tp.named_buffers()} == {"index", "inverse_index"}


# --------------------------------------------------------------------------
# IAF and MAF
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["iaf", "maf"])
def test_both_directions_match_jax(kind, dt):
    """The parallel direction (IAF forward, MAF inverse) and the
    sequential one (``dim`` masked passes a layer)."""
    jflow, tflow = _flows(kind, dt)
    x = _x(dt, scale=1.5)
    for way in ("forward_and_log_det", "inverse_and_log_det"):
        jy, jld = jax.jit(getattr(jflow.bijector, way))(jnp.asarray(x))
        with torch.no_grad():
            ty, tld = getattr(tflow.bijector, way)(torch.from_numpy(x))
        _close(ty, jy, GRAD_TOL[dt], way)
        _close(tld, jld, GRAD_TOL[dt], way)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["iaf", "maf"])
def test_round_trips(kind, dt):
    """Forward then the sequential inverse (IAF), and sampling (MAF's
    sequential direction) against `log_prob` through the parallel one."""
    _, tflow = _flows(kind, dt, seed=3)
    x = torch.from_numpy(_x(dt, n=256, seed=8, scale=1.5))
    with torch.no_grad():
        y, ld = tflow.bijector.forward_and_log_det(x)
        back, ild = tflow.bijector.inverse_and_log_det(y)
        _close(back, x, GRAD_TOL[dt])
        _close(ld + ild, np.zeros(256), (0, GRAD_TOL[dt][0]))
        ys, lq = tflow.sample_and_log_prob(torch.Generator().manual_seed(4),
                                           (256,))
        _close(tflow.log_prob(ys), lq, GRAD_TOL[dt])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_iaf_elbo_and_gradients_match_jax(dt):
    jflow, tflow = _flows("iaf", dt)
    jt, tt = nf.Banana(DIM, 1.0, 10.0), nft.Banana(DIM, 1.0, 10.0)
    xs = _x(dt, seed=10)
    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda f: nf.elbo_from_samples(jnp.asarray(xs), f, jt.log_prob)))(
        jflow)
    val = nft.elbo_from_samples(torch.from_numpy(xs), tflow, tt.log_prob)
    _close(val, jval, TOL[dt])
    val.backward()
    _close_params(tflow, jgrads, GRAD_TOL[dt], grads=True)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_maf_log_prob_and_gradients_match_jax(dt):
    jflow, tflow = _flows("maf", dt)
    y = np.array(nf.Banana(DIM, 1.0, 10.0).sample(
        jax.random.key(9), (N,)), DT[dt][2])

    def jloss(f):
        lp = f.log_prob(jnp.asarray(y))
        return nf.loglikelihood(f, jnp.asarray(y)), lp

    (jll, jlp), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jflow)
    lp = tflow.log_prob(torch.from_numpy(y))
    _close(lp, jlp, TOL[dt])
    ll = nft.loglikelihood(tflow, torch.from_numpy(y))
    _close(ll, jll, TOL[dt])
    ll.backward()
    _close_params(tflow, jgrads, GRAD_TOL[dt], grads=True)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_iaf_train_flow_matches_jax(dt):
    jflow, tflow = _flows("iaf", dt)
    jt, tt = nf.Banana(DIM, 1.0, 10.0), nft.Banana(DIM, 1.0, 10.0)
    draws = np.random.default_rng(11).standard_normal((STEPS, N, DIM)
                                                      ).astype(DT[dt][2])
    jres = nf.train_flow(
        jax.random.key(0), lambda xs, f, lp, n: nf.elbo_from_samples(
            xs, f, lp), jflow, jt.log_prob, N, max_iters=STEPS,
        check_every=STEPS, optimizer=optax.adam(LR),
        scan_inputs=lambda k, f, n: jnp.asarray(draws))
    res = nft.train_flow(
        torch.Generator(), lambda xs, f, lp, n: nft.elbo_from_samples(
            xs, f, lp), tflow, tt.log_prob, N, max_iters=STEPS,
        check_every=STEPS, optimizer=lambda p: torch.optim.Adam(p, lr=LR),
        scan_inputs=lambda g, f, n: torch.from_numpy(draws))
    _close(res.stats["loss"], jres.stats["loss"], TRAIN_TOL[dt])
    _close(res.stats["gradient_norm"], jres.stats["gradient_norm"],
           TRAIN_TOL[dt])
    _close_params(tflow, jres.flow, TRAIN_TOL[dt])


class _Batches:
    """``next_batches(k)``: the next k fixed batches, as numpy."""

    def __init__(self, data):
        self.data, self.pos = data, 0

    def next_batches(self, k):
        out = self.data[self.pos:self.pos + k]
        self.pos += k
        return out


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_maf_train_flow_mle_matches_jax(dt):
    jflow, tflow = _flows("maf", dt)
    data = np.array(nf.Banana(DIM, 1.0, 10.0).sample(
        jax.random.key(5), (STEPS * 16,)), DT[dt][2]).reshape(STEPS, 16, DIM)
    jres = nf.train_flow_mle(jflow, _Batches(data), max_iters=STEPS,
                             check_every=STEPS, optimizer=optax.adam(LR))
    res = nft.train_flow_mle(tflow, _Batches(data), max_iters=STEPS,
                             check_every=STEPS,
                             optimizer=lambda p: torch.optim.Adam(p, lr=LR))
    _close(res.stats["loss"], jres.stats["loss"], TRAIN_TOL[dt])
    _close_params(tflow, jres.flow, TRAIN_TOL[dt])


def test_constructors_default_to_the_card():
    for make in (nft.iaf, nft.maf):
        flow = make(torch.Generator(), 2, (4,), 2, device="cpu")
        assert [type(b).__name__ for b in flow.bijector.bijectors] == (
            ["MaskedAutoregressive", "Permute", "MaskedAutoregressive"]
            if make is nft.iaf else ["Inverse", "Permute", "Inverse"])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(torch.Generator(), 2)
