"""The port's combinators against the JAX package's: `Stacked` (spans and
general index sets), `Repeated`/`stack_bijectors` (with and without
remat) against a `Chain` of the same blocks, `chain`, `transformed`,
`mlp3`, and `utils.pytree`'s `tree_size` and `destructure`.

Tolerances: f64 rtol 1e-9 (atol 1e-12); f32 rtol 1e-5 (atol 1e-6) for
values and log-dets, 1e-4 relative (atol 1e-6) for gradients. A `Repeated`
and a `Chain` of the same blocks run the same operations in the same order
and must agree bit for bit, and so must remat on and off.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.utils.pytree import (  # noqa: E402
    destructure as jax_destructure,
    tree_size as jax_tree_size,
)
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402
from normalizingflows_torch.utils.pytree import (  # noqa: E402
    destructure,
    tree_size,
)

torch.set_num_threads(1)

DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": (1e-5, 1e-6), "f64": (1e-9, 1e-12)}
GRAD_TOL = {"f32": (1e-4, 1e-6), "f64": (1e-9, 1e-12)}


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol[0], atol=tol[1])


def _stacked(dt, ranges, dim):
    """JAX and port `Stacked((Scale(a), Shift(b)), ranges)`, ``a`` and
    ``b`` sized to the two index sets and drawn from a seed."""
    jdt, tdt, ndt = DT[dt]
    rng = np.random.default_rng(0)
    sizes = [len(r) if not (isinstance(r, tuple) and len(r) == 2)
             else r[1] - r[0] for r in ranges]
    a = (1.0 + 0.5 * rng.standard_normal(sizes[0])).astype(ndt)
    b = rng.standard_normal(sizes[1]).astype(ndt)
    jb = nf.Stacked((nf.Scale(jnp.asarray(a)), nf.Shift(jnp.asarray(b))),
                    ranges)
    tb = nft.Stacked((nft.Scale(torch.ones(sizes[0], dtype=tdt)),
                      nft.Shift(torch.zeros(sizes[1], dtype=tdt))), ranges)
    load_jax_params(tb, jax_arrays(jb))
    x = rng.standard_normal((9, dim)).astype(ndt)
    return jb, tb, x


RANGES = {
    "spans": ([(0, 2), (2, 4)], 4),
    "index_sets": ([[0, 2], [1, 3]], 4),
    "spans_out_of_order": ([(3, 5), (0, 3)], 5),
    "strided_range": ([range(0, 6, 3), [1, 2, 4, 5]], 6),
}


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("case", list(RANGES))
def test_stacked_matches_jax(case, dt):
    ranges, dim = RANGES[case]
    jb, tb, x = _stacked(dt, ranges, dim)
    assert tb.spans == (case == "spans")
    assert tb.index_sets == tuple(tuple(s) for s in jb.index_sets)
    c = np.linspace(-1.0, 1.0, x.size).reshape(x.shape).astype(x.dtype)
    for way in ("forward_and_log_det", "inverse_and_log_det"):

        def jloss(v, p):
            y, ld = getattr(p, way)(v)
            return jnp.sum(y * c) + jnp.sum(ld), (y, ld)

        (_, (jy, jld)), (jgx, jgp) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jb)
        xt = torch.from_numpy(x).requires_grad_(True)
        ty, tld = getattr(tb, way)(xt)
        _close(ty, jy, TOL[dt])
        _close(tld, jld, TOL[dt])
        # the gradient through the gather/scatter and the log-det
        (ty * torch.from_numpy(c)).sum().add(tld.sum()).backward()
        _close(xt.grad, jgx, GRAD_TOL[dt])
        want = jax_arrays(jgp)
        for name, p in tb.named_parameters():
            jname = "." + name.replace(".0.", "[0].").replace(".1.", "[1].")
            _close(p.grad, want[jname], GRAD_TOL[dt])
            p.grad = None


@pytest.mark.parametrize("n,ranges,match", [
    (2, [[], [0, 1]], "not be empty"), (2, [(1, 1), (0, 1)], "not be empty"),
    (2, [(0, 2), (1, 3)], "disjoint"), (2, [[0, 2], [1, 4]], "tile"),
    (2, [[0, 0], [1]], "disjoint"), (1, [(0, 1), (1, 2)], "equal length")])
def test_stacked_rejects_empty_overlapping_or_gapped_sets(n, ranges, match):
    """The reference accepts an empty set and fails later
    (`models/bijector.py:305`); the port refuses it when built."""
    with pytest.raises(ValueError, match=match):
        nft.Stacked([nft.Identity() for _ in range(n)], ranges)


def test_stacked_caches_its_index_tensors(monkeypatch):
    """Made once a device: a warm call copies nothing from the host, so a
    CUDA graph can capture it."""
    _, tb, x = _stacked("f64", [[0, 2], [1, 3]], 4)
    xt = torch.from_numpy(x)
    want = tb(xt), tb.inverse(xt)

    def no_copy(*args, **kw):
        raise AssertionError("a host→device index copy after the first call")

    monkeypatch.setattr(torch, "tensor", no_copy)
    assert torch.equal(tb(xt), want[0]) and torch.equal(tb.inverse(xt),
                                                        want[1])


def _planar_pair(dt, nlayers=4, seed=0):
    jdt, tdt, _ = DT[dt]
    jflow = nf.planarflow(jax.random.key(seed),
                          nf.DiagNormal.standard(2, jdt), nlayers, jdt)
    tflow = nft.planarflow(torch.Generator().manual_seed(seed), 2, nlayers,
                           tdt, device="cpu")
    return jflow, load_jax_params(tflow, jax_arrays(jflow))


def _value_and_grads(bij, x, way):
    bij.zero_grad(set_to_none=True)
    y, ld = getattr(bij, way)(x)
    (y.square().sum() + ld.sum()).backward()
    return [y.detach(), ld.detach()] + [p.grad.clone()
                                        for p in bij.parameters()]


@pytest.mark.parametrize("way", ["forward_and_log_det",
                                 "inverse_and_log_det"])
def test_repeated_is_a_chain_of_its_blocks(way):
    """`Repeated` with and without remat and a `Chain` of the same blocks
    (the JAX ``scan=False`` layout): identical values and gradients."""
    _, tflow = _planar_pair("f64")
    rep = tflow.bijector.bijectors[0]
    assert isinstance(rep, nft.Repeated) and rep.n == 4
    ch = nft.chain(*rep.stacked)
    assert isinstance(ch, nft.Chain) and len(ch.bijectors) == 4
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 2)))
    want = _value_and_grads(ch, x, way)
    for remat in (False, True):
        got = _value_and_grads(nft.stack_bijectors(list(rep.stacked), remat),
                               x, way)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_repeated_matches_jax_scan(dt):
    """The JAX default (``scan=True``) planar flow loads unchanged (its
    stacked leaves split across the list) and agrees both ways."""
    jflow, tflow = _planar_pair(dt)
    assert set(jax_arrays(jflow)) == {
        ".base.loc", ".base.scale", ".bijector.bijectors[0].stacked.u",
        ".bijector.bijectors[0].stacked.w",
        ".bijector.bijectors[0].stacked.b"}
    x = np.random.default_rng(4).standard_normal((8, 2)).astype(DT[dt][2])
    for way in ("forward_and_log_det", "inverse_and_log_det"):
        jy, jld = jax.jit(getattr(jflow.bijector, way))(jnp.asarray(x))
        with torch.no_grad():
            ty, tld = getattr(tflow.bijector, way)(torch.from_numpy(x))
        _close(ty, jy, TOL[dt])
        _close(tld, jld, TOL[dt])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_transformed_and_mlp3_match_jax(dt):
    jdt, tdt, ndt = DT[dt]
    rng = np.random.default_rng(6)
    loc, scale = rng.standard_normal(3).astype(ndt), np.full(3, 1.5, ndt)
    shift = rng.standard_normal(3).astype(ndt)
    jd = nf.transformed(nf.DiagNormal(jnp.asarray(loc), jnp.asarray(scale)),
                        nf.Shift(jnp.asarray(shift)))
    td = nft.transformed(nft.DiagNormal(torch.zeros(3, dtype=tdt),
                                        torch.ones(3, dtype=tdt)),
                         nft.Shift(torch.zeros(3, dtype=tdt)))
    assert isinstance(td, nft.TransformedDistribution)
    load_jax_params(td, jax_arrays(jd))
    y = rng.standard_normal((5, 3)).astype(ndt)
    with torch.no_grad():
        _close(td.log_prob(torch.from_numpy(y)), jd.log_prob(jnp.asarray(y)),
               TOL[dt])

    jnet = nf.mlp3(jax.random.key(1), 3, 8, 4, dtype=jdt)
    tnet = nft.mlp3(torch.Generator().manual_seed(1), 3, 8, 4, dtype=tdt,
                    device="cpu")
    assert [tuple(layer.W.shape) for layer in tnet.layers] == [
        (3, 8), (8, 8), (8, 4)]
    assert tnet.layers[-1].activation is None
    load_jax_params(tnet, jax_arrays(jnet))
    with torch.no_grad():
        _close(tnet(torch.from_numpy(y)), jnet(jnp.asarray(y)), TOL[dt])


def test_tree_size_and_destructure_match_jax():
    jflow, tflow = _planar_pair("f64", nlayers=3)
    assert tree_size(tflow) == jax_tree_size(jflow) == 2 + 2 + 3 * 5
    mix = nft.Cross(device="cpu")
    assert tree_size(mix) == jax_tree_size(nf.Cross()) == 20

    theta, re = destructure(tflow)
    jtheta, _ = jax_destructure(jflow)
    assert theta.shape == jtheta.shape and not theta.requires_grad
    # the same numbers, each leaf's in its own package's order
    np.testing.assert_array_equal(np.sort(theta.numpy()),
                                  np.sort(np.asarray(jtheta)))
    back = re(theta)
    assert back is not tflow and type(back) is type(tflow)
    for (n, p), (m, q) in zip(tflow.named_parameters(),
                              back.named_parameters()):
        assert n == m and torch.equal(p, q)
    doubled = re(2 * theta)
    for p, q in zip(tflow.parameters(), doubled.parameters()):
        torch.testing.assert_close(q, 2 * p, rtol=0, atol=0)
    with pytest.raises(ValueError, match="entries"):
        re(theta[:-1])
