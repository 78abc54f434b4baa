"""The port's neural spline flow against the JAX package's.

A JAX `nsf(...)` is built from a key, its parameters are carried over with
`load_jax_params`, and both flows get the same base draws (numpy, from a
seed). Compared: forward and inverse with log-dets, `sample_and_log_prob`,
the ELBO value and the gradient of every parameter, plus Banana,
`DiagNormal`, `interleave` and `PartitionMask`; `nsf(affine_wrap=True)`;
`nsf(remat=True)` against ``remat=False`` (the same bits) and against JAX's
selective remat, and how often it runs the spline forward. The JAX side runs its RQS
kernel as its own tests do: `backend="pallas", interpret=True`, and
`backend="oracle"`.

Tolerances: f64 rtol 1e-9 (atol 1e-9 for values near 0) — the two
packages take the same operations, with exp/log and reductions from
different libraries (about 1e-12 observed through 2 blocks). f32 rtol 1e-4,
atol 1e-4 for values and 2e-3 / 1e-3 for gradients: the f32 kernel-vs-oracle
tolerances of tests/test_rqs_kernel.py, loosened tenfold in atol because 4
couplings compound them. A round trip within the port uses 1e-8 (f64).
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.ops import masks as jax_masks  # noqa: E402
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.ops import masks  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

DIM, HDIMS, NLAYERS, BATCH, BOX = 4, (16, 16), 2, 48, 4.0
DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": dict(v=(1e-4, 1e-4), g=(2e-3, 1e-3)),
       "f64": dict(v=(1e-9, 1e-9), g=(1e-9, 1e-9))}


def jax_arrays(tree) -> dict:
    """A JAX pytree as {path: numpy array}: the bridge's input format."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _close(a, b, tol):
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol[0], atol=tol[1])


def _pair(dt, K, backend="pallas", identity_init=False, seed=0, **kw):
    """A JAX nsf and the port's copy; ``kw`` (``affine_wrap``, ``remat``)
    goes to both."""
    jdt, tdt, _ = DT[dt]
    jflow = nf.nsf(jax.random.key(seed), DIM, HDIMS, K=K, B=BOX,
                   nlayers=NLAYERS, dtype=jdt, backend=backend,
                   interpret=True, identity_init=identity_init, **kw)
    tflow = nft.nsf(torch.Generator().manual_seed(seed), DIM, HDIMS, K=K,
                    B=BOX, nlayers=NLAYERS, dtype=tdt, device="cpu", **kw)
    load_jax_params(tflow, jax_arrays(jflow))
    return jflow, tflow


def _draws(dt, seed=1, n=BATCH, scale=2.0):
    """Base draws N(0, scale²): with the box at B=4, a few percent of the
    coordinates lie outside it (a continuous draw lands on ±B or a knot
    with probability 0)."""
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((n, DIM))).astype(DT[dt][2])


def _perturb(jflow, seed=2, sigma=0.1):
    """Move an identity-initialised flow off the identity: noise of
    ``sigma`` on every parameter. Larger noise drives spline derivatives to
    the 1e-3 floor over several couplings, where the inverse is
    ill-conditioned in both packages alike (its round trip breaks)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + sigma * jnp.asarray(rng.standard_normal(a.shape),
                                          a.dtype), jflow)


# each dtype against both JAX backends, K 8 and 10 (eager interpret-mode
# Pallas costs seconds a case, so not the full product)
@pytest.mark.parametrize("dt,K,backend", [
    ("f32", 10, "pallas"), ("f32", 8, "oracle"),
    ("f64", 8, "pallas"), ("f64", 10, "oracle")])
def test_flow_matches_jax(dt, K, backend):
    jflow, tflow = _pair(dt, K, backend, identity_init=True)
    jflow = _perturb(jflow)
    load_jax_params(tflow, jax_arrays(jflow))
    x = _draws(dt)
    xt = torch.from_numpy(x)
    tol = TOL[dt]["v"]

    y_j, ld_j = jax.jit(jflow.bijector.forward_and_log_det)(jnp.asarray(x))
    y_t, ld_t = tflow.bijector.forward_and_log_det(xt)
    _close(y_t, y_j, tol)
    _close(ld_t, ld_j, tol)

    xi_j, ldi_j = jax.jit(jflow.bijector.inverse_and_log_det)(y_j)
    xi_t, ldi_t = tflow.bijector.inverse_and_log_det(y_t)
    _close(xi_t, xi_j, tol)
    _close(ldi_t, ldi_j, tol)

    # sample_and_log_prob from given draws: the port's generator makes them
    g = torch.Generator().manual_seed(3)
    ys_t, lq_t = tflow.sample_and_log_prob(g, (BATCH,))
    xs = tflow.base.sample(torch.Generator().manual_seed(3), (BATCH,))
    ys_j, ld_s = jax.jit(jflow.bijector.forward_and_log_det)(
        jnp.asarray(xs.detach().numpy()))
    _close(ys_t, ys_j, tol)
    _close(lq_t, jflow.base.log_prob(jnp.asarray(xs.detach().numpy())) - ld_s,
           tol)


@pytest.mark.parametrize("dt,backend", [
    ("f32", "pallas"), ("f64", "pallas"), ("f64", "oracle")])
def test_elbo_and_gradients_match_jax(dt, backend):
    """`elbo_from_samples` value and the gradient of every conditioner W
    and b (and the base's loc/scale) against `jax.grad`: through the
    Pallas kernel's analytic VJP, or autodiff of the oracle."""
    jflow, tflow = _pair(dt, 10, backend, identity_init=True)
    jflow = _perturb(jflow)
    load_jax_params(tflow, jax_arrays(jflow))
    x = _draws(dt, seed=4)
    jt, tt = nf.Banana(DIM, 1.0, 100.0), nft.Banana(DIM, 1.0, 100.0)

    val_j, grads_j = jax.jit(jax.value_and_grad(
        lambda f: nf.elbo_from_samples(jnp.asarray(x), f, jt.log_prob)))(jflow)
    val_t = nft.elbo_from_samples(torch.from_numpy(x), tflow, tt.log_prob)
    val_t.backward()
    _close(val_t, val_j, TOL[dt]["v"])

    # map JAX's gradient pytree onto the port's parameter names
    gmod = load_jax_params(copy.deepcopy(tflow), jax_arrays(grads_j))
    ref = dict(gmod.named_parameters())
    names = [n for n, _ in tflow.named_parameters()]
    assert sum(".W" in n for n in names) == 2 * NLAYERS * (len(HDIMS) + 1)
    for name, p in tflow.named_parameters():
        _close(p.grad, ref[name].detach().numpy(), TOL[dt]["g"])


@pytest.mark.parametrize("dt,K", [("f32", 8), ("f64", 10)])
def test_coupling_layers_match_jax(dt, K):
    """`NSF_layer` and its two `NeuralSplineCoupling`s on their own, as a
    `Chain`, against the JAX package's (oracle path): forward, inverse and
    the gradient of every conditioner W and b. `SplinePairStack.from_pairs`
    of the same couplings is the same function: it takes the same
    operations in the same order, so it agrees to the last bits (rtol 1e-6
    f32, 1e-12 f64)."""
    jdt, tdt, _ = DT[dt]
    jpair = _perturb(nf.Chain(nf.NSF_layer(
        jax.random.key(11), DIM, HDIMS, K, BOX, jdt, backend="oracle",
        identity_init=True)))
    tpair = nft.Chain(nft.NSF_layer(torch.Generator().manual_seed(11), DIM,
                                    HDIMS, K, BOX, tdt, device="cpu"))
    load_jax_params(tpair, jax_arrays(jpair))
    x = _draws(dt, seed=12)
    xt = torch.from_numpy(x)
    tol = TOL[dt]

    y_j, ld_j = jax.jit(jpair.forward_and_log_det)(jnp.asarray(x))
    y_t, ld_t = tpair.forward_and_log_det(xt)
    _close(y_t, y_j, tol["v"])
    _close(ld_t, ld_j, tol["v"])
    xi_j, ldi_j = jax.jit(jpair.inverse_and_log_det)(y_j)
    xi_t, ldi_t = tpair.inverse_and_log_det(y_t.detach())
    _close(xi_t, xi_j, tol["v"])
    _close(ldi_t, ldi_j, tol["v"])

    def loss(c):
        y, ld = c.forward_and_log_det(jnp.asarray(x))
        return jnp.sum(y) + jnp.sum(ld)

    gmod = load_jax_params(copy.deepcopy(tpair),
                           jax_arrays(jax.jit(jax.grad(loss))(jpair)))
    (y_t.sum() + ld_t.sum()).backward()
    ref = dict(gmod.named_parameters())
    assert len(ref) == 2 * 2 * (len(HDIMS) + 1)
    for name, p in tpair.named_parameters():
        _close(p.grad, ref[name].detach().numpy(), tol["g"])

    stack = nft.SplinePairStack.from_pairs([list(tpair.bijectors)])
    same = (1e-6, 0) if dt == "f32" else (1e-12, 0)
    with torch.no_grad():
        for a, b in zip(stack.forward_and_log_det(xt), (y_t, ld_t)):
            _close(a, b.detach().numpy(), same)
        for a, b in zip(stack.inverse_and_log_det(y_t), (xi_t, ldi_t)):
            _close(a, b.detach().numpy(), same)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_identity_init_matches_jax(dt):
    jflow, tflow = _pair(dt, 10, "oracle", identity_init=True)
    t2 = nft.nsf(torch.Generator().manual_seed(5), DIM, HDIMS, K=10, B=BOX,
                 nlayers=NLAYERS, dtype=DT[dt][1], identity_init=True,
                 device="cpu")
    for net in t2.bijector.bijectors[0].stacked["even"]:
        assert torch.count_nonzero(net.layers[-1].W) == 0
    x = _draws(dt, seed=6)
    y_j, ld_j = jflow.bijector.forward_and_log_det(jnp.asarray(x))
    for flow in (tflow, t2):
        y_t, ld_t = flow.bijector.forward_and_log_det(torch.from_numpy(x))
        _close(y_t, y_j, TOL[dt]["v"])
        _close(ld_t, ld_j, TOL[dt]["v"])
        _close(y_t, x, (0, 1e-4 if dt == "f32" else 1e-9))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_banana_and_base_log_prob_match_jax(dt):
    jdt, tdt, ndt = DT[dt]
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((BATCH, DIM))).astype(ndt)
    for d, b, var in ((2, 1.0, 100.0), (DIM, 0.5, 10.0)):
        _close(nft.Banana(d, b, var).log_prob(torch.from_numpy(x[:, :d])),
               nf.Banana(d, b, var).log_prob(jnp.asarray(x[:, :d])),
               TOL[dt]["v"])
    loc = rng.standard_normal(DIM).astype(ndt)
    scale = np.exp(rng.standard_normal(DIM)).astype(ndt)
    tb = nft.DiagNormal(torch.from_numpy(loc), torch.from_numpy(scale))
    jb = nf.DiagNormal(jnp.asarray(loc), jnp.asarray(scale))
    _close(tb.log_prob(torch.from_numpy(x)), jb.log_prob(jnp.asarray(x)),
           TOL[dt]["v"])
    _close(nft.StandardNormal(DIM, tdt, "cpu").log_prob(torch.from_numpy(x)),
           nf.StandardNormal(DIM, jdt).log_prob(jnp.asarray(x)),
           TOL[dt]["v"])


def test_banana_sample_is_the_pushforward():
    """Banana(d, b, var).sample is N(0, diag(var, 1, …)) pushed through ϕ:
    ϕ⁻¹ of the draws has the Gaussian's moments (20,000 draws; 5 standard
    errors), and their log-density matches the JAX package's."""
    b, var = 0.5, 10.0
    t = nft.Banana(3, b, var)
    x = t.sample(torch.Generator().manual_seed(9), (20000,),
                 dtype=torch.float64)
    z1 = x[:, 1] + b * x[:, 0] ** 2 - var * b
    z = torch.stack([x[:, 0], z1, x[:, 2]], dim=1)
    np.testing.assert_allclose(z.mean(0).numpy(), 0.0,
                               atol=5 * np.sqrt(var / 20000))
    np.testing.assert_allclose(z.var(0).numpy(), [var, 1.0, 1.0],
                               rtol=5 * np.sqrt(2 / 20000))
    _close(t.log_prob(x[:100]), nf.Banana(3, b, var).log_prob(
        jnp.asarray(x[:100].numpy())), TOL["f64"]["v"])


@pytest.mark.parametrize("dim", [2, 3, 5, 6])
def test_interleave_matches_jax(dim):
    rng = np.random.default_rng(dim)
    a = rng.standard_normal((3, (dim + 1) // 2))
    b = rng.standard_normal((3, dim // 2))
    out = masks.interleave(torch.from_numpy(a), torch.from_numpy(b), dim)
    np.testing.assert_array_equal(
        out.numpy(), jax_masks.interleave(jnp.asarray(a), jnp.asarray(b),
                                          dim))


@pytest.mark.parametrize("dim,idx_a", [(4, (0, 2)), (4, (1, 3)), (5, (1,)),
                                       (6, (0, 3)), (6, (5, 1, 2)), (2, (0,))])
def test_partition_mask_matches_jax(dim, idx_a):
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((3, dim))
    tm, jm = masks.PartitionMask.make(dim, idx_a), \
        jax_masks.PartitionMask.make(dim, idx_a)
    assert (tm.idx_a, tm.idx_b, tm.idx_c) == (jm.idx_a, jm.idx_b, jm.idx_c)
    parts_t = tm.partition(torch.from_numpy(x))
    parts_j = jm.partition(jnp.asarray(x))
    for a, b in zip(parts_t, parts_j):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(tm.combine(*parts_t).numpy(),
                                  jm.combine(*parts_j))
    np.testing.assert_array_equal(tm.combine(*parts_t).numpy(), x)


def test_round_trip_within_the_port():
    """log_prob(y) through the inverse equals sample_and_log_prob's value."""
    jflow, tflow = _pair("f64", 8, "oracle", identity_init=True)
    load_jax_params(tflow, jax_arrays(_perturb(jflow)))
    g = torch.Generator().manual_seed(8)
    y, lq = tflow.sample_and_log_prob(g, (BATCH,))
    _close(tflow.log_prob(y), lq.detach().numpy(), (1e-8, 1e-8))


def test_bridge_rejects_what_does_not_fit():
    jflow, tflow = _pair("f32", 8, "oracle")
    arrays = jax_arrays(jflow)
    path = ".bijector.bijectors[0].stacked['even'].layers[0].W"
    with pytest.raises(KeyError, match="no value"):
        load_jax_params(tflow, {k: v for k, v in arrays.items()
                                if k != path})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tflow, {**arrays, path: arrays[path][:, :, :3]})
    with pytest.raises(KeyError, match="parse"):
        load_jax_params(tflow, {"bijector..W": arrays[path]})


def test_every_option_builds_and_unknown_backend_raises():
    """Every option is ported: the bf16 ``compute_dtype`` (which raised
    until it was) builds and gives JAX's forward (its Pallas kernel in
    interpret mode, on the same bfloat16 raw) within 1e-4; ``remat`` and
    ``affine_wrap`` build (their tests are below); an unknown backend
    raises."""
    g = torch.Generator().manual_seed(0)
    jflow = _perturb(nf.nsf(jax.random.key(0), DIM, HDIMS, K=8, B=BOX,
                            nlayers=NLAYERS, backend="pallas",
                            interpret=True, identity_init=True,
                            compute_dtype=jnp.bfloat16))
    pol = nft.nsf(g, DIM, HDIMS, K=8, B=BOX, nlayers=NLAYERS,
                  identity_init=True, device="cpu",
                  compute_dtype=torch.bfloat16)
    load_jax_params(pol, jax_arrays(jflow))
    x = _draws("f32")
    y_j, ld_j = jax.jit(jflow.bijector.forward_and_log_det)(jnp.asarray(x))
    y_t, ld_t = pol.bijector.forward_and_log_det(torch.from_numpy(x))
    _close(y_t, y_j, (1e-4, 1e-4))
    _close(ld_t, ld_j, (1e-4, 1e-4))
    flow = nft.nsf(g, DIM, HDIMS, device="cpu", remat=True, affine_wrap=True)
    assert flow.bijector.bijectors[1].remat
    with pytest.raises(ValueError):
        nft.nsf(g, DIM, HDIMS, device="cpu", backend="pallas")


# --------------------------------------------------------------------------
# the affine envelope and the selective remat
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dt,backend", [("f32", "pallas"), ("f64", "oracle")])
def test_affine_wrap_matches_jax(dt, backend):
    """`nsf(affine_wrap=True)`: an ActNorm on each side of the stack, at
    ``.bijector.bijectors[0]`` and ``[2]`` (the stack at ``[1]``), moved
    off the identity; forward, inverse, `log_prob`, the ELBO and the
    gradient of every parameter, the ActNorms' included."""
    jflow, tflow = _pair(dt, 10, backend, identity_init=True,
                         affine_wrap=True)
    jflow = _perturb(jflow)
    load_jax_params(tflow, jax_arrays(jflow))
    kinds = [type(b).__name__ for b in tflow.bijector.bijectors]
    assert kinds == ["ActNorm", "SplinePairStack", "ActNorm"]
    x = _draws(dt, seed=13)
    tol = TOL[dt]
    y_j, ld_j = jax.jit(jflow.bijector.forward_and_log_det)(jnp.asarray(x))
    y_t, ld_t = tflow.bijector.forward_and_log_det(torch.from_numpy(x))
    _close(y_t, y_j, tol["v"])
    _close(ld_t, ld_j, tol["v"])
    _close(tflow.log_prob(y_t.detach()),
           jax.jit(jflow.log_prob)(y_j), tol["v"])

    jt, tt = nf.Banana(DIM, 1.0, 100.0), nft.Banana(DIM, 1.0, 100.0)
    val_j, grads_j = jax.jit(jax.value_and_grad(
        lambda f: nf.elbo_from_samples(jnp.asarray(x), f, jt.log_prob)))(jflow)
    val_t = nft.elbo_from_samples(torch.from_numpy(x), tflow, tt.log_prob)
    val_t.backward()
    _close(val_t, val_j, tol["v"])
    ref = dict(load_jax_params(copy.deepcopy(tflow),
                               jax_arrays(grads_j)).named_parameters())
    assert {"bijector.bijectors.0.log_scale",
            "bijector.bijectors.2.shift"} <= set(ref)
    for name, p in tflow.named_parameters():
        _close(p.grad, ref[name].detach().numpy(), tol["g"])


def _remat_pair(dt, seed=0):
    """Two copies of one perturbed flow, ``remat`` False and True."""
    flows = []
    for remat in (False, True):
        f = nft.nsf(torch.Generator().manual_seed(seed), DIM, HDIMS, K=8,
                    B=BOX, nlayers=NLAYERS, dtype=DT[dt][1], device="cpu",
                    identity_init=True, remat=remat, affine_wrap=True)
        noise = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for p in f.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=noise,
                                         dtype=p.dtype))
        flows.append(f)
    return flows


OBJECTIVES = {
    "elbo": lambda f, x: nft.elbo_from_samples(
        x, f, nft.Banana(DIM, 1.0, 100.0).log_prob),
    "loglikelihood": lambda f, x: nft.loglikelihood(f, x),
    "elbo_stl": lambda f, x: nft.elbo_stl(
        torch.Generator().manual_seed(5), f,
        nft.Banana(DIM, 1.0, 100.0).log_prob, BATCH),
}


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
def test_remat_gives_the_same_loss_and_gradients(objective, dt):
    """The selective remat against no remat, both directions (the ELBO
    runs the stack forward, the log-likelihood inverse, the STL ELBO both):
    the same operations in the same order, so the same bits."""
    plain, remat = _remat_pair(dt)
    x = torch.from_numpy(_draws(dt, seed=14))
    out = []
    for f in (plain, remat):
        val = OBJECTIVES[objective](f, x)
        val.backward()
        out.append((val.detach(), [p.grad for p in f.parameters()]))
    (v0, g0), (v1, g1) = out
    assert torch.equal(v0, v1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_remat_matches_jax_remat():
    """The port's remat against JAX's `save_only_these_names("rqs_out")`
    remat over the Pallas kernel in interpret mode (f32): the ELBO and its
    gradients."""
    jflow, tflow = _pair("f32", 10, "pallas", identity_init=True, remat=True)
    jflow = _perturb(jflow)
    load_jax_params(tflow, jax_arrays(jflow))
    x = _draws("f32", seed=15)
    jt, tt = nf.Banana(DIM, 1.0, 100.0), nft.Banana(DIM, 1.0, 100.0)
    val_j, grads_j = jax.jit(jax.value_and_grad(
        lambda f: nf.elbo_from_samples(jnp.asarray(x), f, jt.log_prob)))(jflow)
    val_t = nft.elbo_from_samples(torch.from_numpy(x), tflow, tt.log_prob)
    val_t.backward()
    _close(val_t, val_j, TOL["f32"]["v"])
    ref = dict(load_jax_params(copy.deepcopy(tflow),
                               jax_arrays(grads_j)).named_parameters())
    for name, p in tflow.named_parameters():
        _close(p.grad, ref[name].detach().numpy(), TOL["f32"]["g"])


@pytest.mark.parametrize("objective,fwd,bwd", [
    ("elbo", "tile_transform", "tile_bwd_analytic"),
    ("loglikelihood", "tile_transform", "tile_bwd_analytic_inverse")])
@pytest.mark.parametrize("remat", [False, True])
def test_remat_runs_the_spline_forward_once_a_coupling(objective, fwd, bwd,
                                                       remat, monkeypatch):
    """On the CPU the plain tiles stand for K1 and K2/K3: one step (value
    and gradient) runs the spline forward once a coupling and its VJP once
    a coupling, with remat as without. `torch.utils.checkpoint` around a
    block would run the forward twice a coupling."""
    from normalizingflows_torch.ops import rqs_cuda

    calls = {fwd: 0, bwd: 0}
    for name in calls:
        tile = getattr(rqs_cuda, name)

        def counted(*a, _tile=tile, _name=name, **kw):
            calls[_name] += 1
            return _tile(*a, **kw)

        monkeypatch.setattr(rqs_cuda, name, counted)
    flow = _remat_pair("f32")[int(remat)]
    OBJECTIVES[objective](flow, torch.from_numpy(_draws("f32"))).backward()
    assert calls == {fwd: 2 * NLAYERS, bwd: 2 * NLAYERS}
