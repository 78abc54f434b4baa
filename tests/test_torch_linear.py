"""The port's ActNorm, PLU mixing and Glow against the JAX package's.

`ActNorm`: identity, Glow's data-dependent init from an 8-row batch (so a
standard deviation with ddof 1 in place of JAX's ddof 0 would miss by
√(8/7)), forward, inverse and round trip. `InvertibleLinear`: the PLU
factors `make` draws from an int seed equal JAX's bit for bit; forward,
inverse (two triangular solves), log-det, round trip; ``pmat`` and
``sign_s`` are buffers that 5 Adam steps leave as they were. `glow`
(the `Repeated` layout against JAX's ``scan=True``, a `Chain` of blocks
against ``scan=False``): forward, inverse, `log_prob`, the ELBO and its
gradients, 5 Adam steps of `train_flow` on the same draws.
`glow_init_actnorms` on both layouts and on `nsf(affine_wrap=True)`'s bare
ActNorms, and its ValueError.

Tolerances: f64 rtol 1e-9 (atol 1e-12); f32 rtol 1e-5 for values and
log-dets, 1e-4 for gradients and round trips (`tests/test_flows.py`),
each with atol 1e-5: values of order 1 mixed through three blocks of
matmuls keep their rounding where they cancel to near 0 (1.4e-6 at one
of 128 outputs); the 5 Adam steps `tests/test_torch_train.py`'s rtol 1e-4
(atol 1e-5; f64 1e-8, 1e-12).
"""

import copy

import numpy as np
import optax
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": (1e-5, 1e-5), "f64": (1e-9, 1e-12)}
GRAD_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-9, 1e-12)}
TRAIN_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-8, 1e-12)}
DIM, HDIMS, NLAYERS, N, LR, STEPS = 4, (8, 8), 3, 32, 1e-2, 5


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _close(got, want, tol, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol[0],
                               atol=tol[1], err_msg=msg)


def _close_params(tflow, jtree, tol, grads=False):
    """Each of ``tflow``'s parameters (or their gradients) against the
    same leaf of ``jtree``, matched by the weight bridge."""
    ref = dict(load_jax_params(copy.deepcopy(tflow),
                               jax_arrays(jtree)).named_parameters())
    for name, p in tflow.named_parameters():
        _close(p.grad if grads else p, ref[name].detach().numpy(), tol, name)


def _x(dt, n=N, seed=7, scale=1.5):
    return (scale * np.random.default_rng(seed).standard_normal((n, DIM))
            ).astype(DT[dt][2])


def _perturb(jtree, seed=2, sigma=0.1):
    """Noise on every trainable leaf (ActNorms off the identity); P and
    sign(s) stay a permutation and signs."""
    rng = np.random.default_rng(seed)

    def noisy(path, a):
        if jax.tree_util.keystr(path).endswith(("pmat", "sign_s")):
            return a
        return a + sigma * jnp.asarray(rng.standard_normal(a.shape), a.dtype)

    return jax.tree_util.tree_map_with_path(noisy, jtree)


def _glows(dt, scan=True, seed=0, dim=DIM):
    """The JAX glow (perturbed) and the port's copy: `glow` for
    ``scan=True``, a `Chain` of the same blocks for JAX's ``scan=False``."""
    jdt, tdt, _ = DT[dt]
    jflow = _perturb(nf.glow(jax.random.key(seed), dim, HDIMS, NLAYERS,
                             jdt, scan=scan))
    tflow = nft.glow(torch.Generator().manual_seed(seed), dim, HDIMS,
                     NLAYERS, tdt, device="cpu")
    if not scan:
        tflow = nft.create_flow(list(tflow.bijector.bijectors[0].stacked),
                                tflow.base)
    return jflow, load_jax_params(tflow, jax_arrays(jflow))


# --------------------------------------------------------------------------
# ActNorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_actnorm_identity_and_initialize_match_jax(dt):
    jdt, tdt, _ = DT[dt]
    x = _x(dt, n=8, seed=1, scale=3.0) + 2.0
    ident = nft.ActNorm.identity(DIM, tdt, "cpu")
    y, ld = ident.forward_and_log_det(torch.from_numpy(x))
    assert torch.equal(y, torch.from_numpy(x)) and not ld.any()
    assert ld.shape == (8,) and ld.dtype == tdt

    jan = nf.ActNorm.initialize(jnp.asarray(x))
    tan = nft.ActNorm.initialize(torch.from_numpy(x))
    _close(tan.log_scale, jan.log_scale, TOL[dt])
    _close(tan.shift, jan.shift, TOL[dt])
    with torch.no_grad():
        out = tan(torch.from_numpy(x))
    _close(out.mean(0), np.zeros(DIM), (0, 1e-5 if dt == "f32" else 1e-12))
    # the population standard deviation: ddof 0
    _close(out.std(0, correction=0), np.ones(DIM), (1e-5, 0))
    # dtype pins the parameters' dtype, whatever the batch's
    pinned = nft.ActNorm.initialize(torch.from_numpy(x), dtype=torch.float32)
    assert pinned.log_scale.dtype == torch.float32


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_actnorm_forward_inverse_match_jax(dt):
    jan = _perturb(nf.ActNorm.identity(DIM, DT[dt][0]), sigma=0.5)
    tan = load_jax_params(nft.ActNorm.identity(DIM, DT[dt][1], "cpu"),
                          jax_arrays(jan))
    x = _x(dt)
    for way in ("forward_and_log_det", "inverse_and_log_det"):
        jy, jld = getattr(jan, way)(jnp.asarray(x))
        ty, tld = getattr(tan, way)(torch.from_numpy(x))
        _close(ty, jy, TOL[dt], way)
        _close(tld, jld, TOL[dt], way)
    with torch.no_grad():
        back, ild = tan.inverse_and_log_det(tan(torch.from_numpy(x)))
    _close(back, x, GRAD_TOL[dt])
    assert float(ild[0]) == -float(tan.log_scale.detach().sum())


# --------------------------------------------------------------------------
# InvertibleLinear
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("seed,dim", [(0, 2), (7, 5)])
def test_invertible_linear_make_gives_jaxs_factors(seed, dim, dt):
    jdt, tdt, _ = DT[dt]
    jl = nf.InvertibleLinear.make(seed, dim, jdt)
    tl = nft.InvertibleLinear.make(seed, dim, tdt, "cpu")
    for name in ("lower", "upper", "log_s", "pmat", "sign_s"):
        got = getattr(tl, name)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(getattr(jl, name)), name)
    assert {n for n, _ in tl.named_parameters()} == {"lower", "upper",
                                                      "log_s"}
    assert {n for n, _ in tl.named_buffers()} == {"pmat", "sign_s"}
    # a generator seeds a rotation too: the same one for the same seed
    a = nft.InvertibleLinear.make(torch.Generator().manual_seed(3), dim,
                                  torch.float64, "cpu")
    b = nft.InvertibleLinear.make(torch.Generator().manual_seed(3), dim,
                                  torch.float64, "cpu")
    assert torch.equal(a.upper, b.upper) and torch.equal(a.pmat, b.pmat)
    with torch.no_grad():
        L, U = a._plu()
        W = a.pmat @ L @ U
    _close(W @ W.T, np.eye(dim), (0, 1e-12))


def test_bridge_fills_the_buffers_and_misses_none():
    """The bridge copies P and sign(s) into their buffers; a buffer left
    without a value, or a JAX leaf with no tensor to go to, raises."""
    arrays = jax_arrays(nf.InvertibleLinear.make(9, 3, jnp.float64))
    tl = load_jax_params(nft.InvertibleLinear.make(0, 3, torch.float64,
                                                   "cpu"), arrays)
    np.testing.assert_array_equal(tl.pmat.numpy(), arrays[".pmat"])
    np.testing.assert_array_equal(tl.sign_s.numpy(), arrays[".sign_s"])
    with pytest.raises(KeyError, match="no value.*pmat"):
        load_jax_params(tl, {k: v for k, v in arrays.items()
                             if k != ".pmat"})
    with pytest.raises(KeyError, match="has no 'scale'"):
        load_jax_params(tl, {**arrays, ".scale": arrays[".log_s"]})


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_invertible_linear_matches_jax(dt):
    jl = _perturb(nf.InvertibleLinear.make(4, DIM, DT[dt][0]), sigma=0.3)
    tl = load_jax_params(nft.InvertibleLinear.make(0, DIM, DT[dt][1], "cpu"),
                         jax_arrays(jl))
    x = _x(dt)
    for way in ("forward_and_log_det", "inverse_and_log_det"):
        jy, jld = jax.jit(getattr(jl, way))(jnp.asarray(x))
        ty, tld = getattr(tl, way)(torch.from_numpy(x))
        _close(ty, jy, TOL[dt], way)
        _close(tld, jld, TOL[dt], way)
    with torch.no_grad():
        y, ld = tl.forward_and_log_det(torch.from_numpy(x))
        back, ild = tl.inverse_and_log_det(y)
    _close(back, x, GRAD_TOL[dt])
    _close(ld + ild, np.zeros(N), (0, 1e-12))
    # a batch of any leading shape
    with torch.no_grad():
        y3, _ = tl.forward_and_log_det(torch.from_numpy(x).reshape(4, 8, DIM))
        b3, _ = tl.inverse_and_log_det(y3)
    _close(b3.reshape(N, DIM), x, GRAD_TOL[dt])


# --------------------------------------------------------------------------
# glow
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("scan", [True, False])
def test_glow_forward_inverse_and_log_prob_match_jax(scan, dt):
    jflow, tflow = _glows(dt, scan)
    assert isinstance(tflow.bijector.bijectors[0], nft.Repeated) == scan
    x = _x(dt)
    for way in ("forward_and_log_det", "inverse_and_log_det"):
        jy, jld = jax.jit(getattr(jflow.bijector, way))(jnp.asarray(x))
        with torch.no_grad():
            ty, tld = getattr(tflow.bijector, way)(torch.from_numpy(x))
        _close(ty, jy, TOL[dt], way)
        _close(tld, jld, TOL[dt], way)
    jlp = jax.jit(jflow.log_prob)(jnp.asarray(x))
    with torch.no_grad():
        _close(tflow.log_prob(torch.from_numpy(x)), jlp, TOL[dt])
        y, lq = tflow.sample_and_log_prob(torch.Generator().manual_seed(1),
                                          (N,))
        _close(tflow.log_prob(y), lq, GRAD_TOL[dt])


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("scan", [True, False])
def test_glow_elbo_and_gradients_match_jax(scan, dt):
    jflow, tflow = _glows(dt, scan, seed=1, dim=2)  # Cross is 2-D
    jt = nf.Cross(dtype=DT[dt][0])
    tt = nft.Cross(dtype=DT[dt][1], device="cpu")
    xs = _x(dt, seed=10, scale=1.0)[:, :2]
    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda f: nf.elbo_from_samples(jnp.asarray(xs), f, jt.log_prob)))(
        jflow)
    val = nft.elbo_from_samples(torch.from_numpy(xs), tflow, tt.log_prob)
    _close(val, jval, TOL[dt])
    val.backward()
    _close_params(tflow, jgrads, GRAD_TOL[dt], grads=True)
    assert all(b.grad is None for b in tflow.buffers())


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_glow_train_flow_matches_jax_and_leaves_p_and_signs(dt):
    """5 Adam steps on the same draws; P and sign(s) neither reach the
    optimizer nor move."""
    jflow, tflow = _glows(dt)
    jt, tt = nf.Banana(DIM, 1.0, 10.0), nft.Banana(DIM, 1.0, 10.0)
    frozen = {n: b.clone() for n, b in tflow.named_buffers()}
    assert len(frozen) == 2 * NLAYERS
    draws = np.random.default_rng(11).standard_normal((STEPS, N, DIM)
                                                      ).astype(DT[dt][2])
    jres = nf.train_flow(
        jax.random.key(0), lambda xs, f, lp, n: nf.elbo_from_samples(
            xs, f, lp), jflow, jt.log_prob, N, max_iters=STEPS,
        check_every=STEPS, optimizer=optax.adam(LR),
        scan_inputs=lambda k, f, n: jnp.asarray(draws))
    seen = []

    def adam(params):
        seen.extend(params)
        return torch.optim.Adam(params, lr=LR)

    res = nft.train_flow(
        torch.Generator(), lambda xs, f, lp, n: nft.elbo_from_samples(
            xs, f, lp), tflow, tt.log_prob, N, max_iters=STEPS,
        check_every=STEPS, optimizer=adam,
        scan_inputs=lambda g, f, n: torch.from_numpy(draws))
    _close(res.stats["loss"], jres.stats["loss"], TRAIN_TOL[dt])
    _close_params(tflow, jres.flow, TRAIN_TOL[dt])
    ids = {id(p) for p in seen}
    for name, b in tflow.named_buffers():
        assert id(b) not in ids
        assert torch.equal(b, frozen[name]), name
    jtrained = jax_arrays(jres.flow)
    for name, b in tflow.named_buffers():
        i = int(name.split(".")[4])
        path = (f".bijector.bijectors[0].stacked.mix."
                f"{name.rsplit('.', 1)[1]}")
        np.testing.assert_array_equal(b.numpy(), jtrained[path][i])


def test_glow_constructor_options():
    g = torch.Generator().manual_seed(0)
    flow = nft.glow(g, 3, (4,), 2, torch.float64, device="cpu", remat=True,
                    mix_seed=5)
    rep = flow.bijector.bijectors[0]
    assert rep.remat and rep.n == 2
    # block i's rotation from the int seed mix_seed·1000003 + i
    want = nft.InvertibleLinear.make(5 * 1000003 + 1, 3, torch.float64,
                                     "cpu")
    assert torch.equal(rep.stacked[1].mix.upper, want.upper)
    with pytest.raises(NotImplementedError):
        nft.glow(g, 3, device="cpu", compute_dtype=torch.bfloat16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            nft.glow(g, 3)


# --------------------------------------------------------------------------
# glow_init_actnorms
# --------------------------------------------------------------------------

def _nsf_wrapped(dt):
    jflow = _perturb(nf.nsf(jax.random.key(3), DIM, HDIMS, K=8, B=4.0,
                            nlayers=2, dtype=DT[dt][0], backend="oracle",
                            identity_init=True, affine_wrap=True))
    tflow = nft.nsf(torch.Generator(), DIM, HDIMS, K=8, B=4.0, nlayers=2,
                    dtype=DT[dt][1], device="cpu", affine_wrap=True)
    return jflow, load_jax_params(tflow, jax_arrays(jflow))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("layout", ["repeated", "chain", "bare"])
def test_glow_init_actnorms_matches_jax(layout, dt):
    """The Repeated of blocks (activations threaded block to block), a
    Chain of blocks, and bare top-level ActNorms around an NSF stack.
    In place: the flow passed in is the one returned."""
    jflow, tflow = (_nsf_wrapped(dt) if layout == "bare"
                    else _glows(dt, scan=layout == "repeated"))
    x = _x(dt, n=64, seed=12, scale=2.0)
    jinit = nf.glow_init_actnorms(jflow, jnp.asarray(x))
    before = {n: p.clone() for n, p in tflow.named_parameters()}
    out = nft.glow_init_actnorms(tflow, torch.from_numpy(x))
    assert out is tflow
    _close_params(tflow, jinit, GRAD_TOL[dt])
    moved = {n for n, p in tflow.named_parameters()
             if not torch.equal(p, before[n])}
    assert moved and all(("actnorm" in n) or (
        layout == "bare" and ".stacked." not in n) for n in moved)
    # the first ActNorm's output over the batch is standardised
    first = (tflow.bijector.bijectors[0] if layout == "bare" else
             (tflow.bijector.bijectors[0].stacked[0] if layout == "repeated"
              else tflow.bijector.bijectors[0]).actnorm)
    with torch.no_grad():
        z = first(torch.from_numpy(x))
    _close(z.mean(0), np.zeros(DIM), (0, 1e-5))
    assert all(p.dtype == DT[dt][1] for p in tflow.parameters())


def test_glow_init_actnorms_keeps_dtype_and_raises_without_actnorm():
    """A float64 batch initializes a float32 flow as the batch cast to
    float32 does, and leaves its parameters float32."""
    _, tflow = _glows("f32")
    twin = copy.deepcopy(tflow)
    x = torch.from_numpy(_x("f64", n=64))
    nft.glow_init_actnorms(tflow, x)
    nft.glow_init_actnorms(twin, x.float())
    for p, q in zip(tflow.parameters(), twin.parameters()):
        assert p.dtype == torch.float32 and torch.equal(p, q)
    rnvp = nft.realnvp(torch.Generator(), DIM, HDIMS, 2, device="cpu")
    with pytest.raises(ValueError, match="no ActNorm"):
        nft.glow_init_actnorms(rnvp, x.float())
    with pytest.raises(ValueError, match="no ActNorm"):
        nf.glow_init_actnorms(
            nf.realnvp(jax.random.key(0), DIM, HDIMS, 2),
            jnp.asarray(x.numpy(), jnp.float32))
