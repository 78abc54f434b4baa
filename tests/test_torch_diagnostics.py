"""The port's VI diagnostics against the JAX package's, on shared draws.

Each estimator draws its base samples from the flow's base. Here the
port's flow gets a base that hands out the draws the JAX function makes
from its key (`_Given`), so `log_weights`, `elbo_with_sem`,
`log_normalizer`, `ess` and `evaluate_flow` see the same samples on both
sides. `sliced_wasserstein2` draws its directions: the port's helper
`_sliced_w2` gets the directions JAX draws from its key. Flow: a 2-D
RealNVP (2 blocks, noise 0.1 on every parameter) on Banana(2, 1, 10).

Tolerances: f64 rtol 1e-9 (atol 1e-12); f32 rtol 1e-5 (atol 1e-5), the
ESS and log Ẑ (exponentials of sums of 512 log-weights) rtol 1e-4.
Histogram counts are exact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch import diagnostics  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": (1e-5, 1e-5), "f64": (1e-9, 1e-12)}
EXP_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-9, 1e-12)}
N = 512


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _close(got, want, tol, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol[0],
                               atol=tol[1], err_msg=msg)


class _Given(nft.DiagNormal):
    """The JAX flow's base, whose `sample` hands out the draws that base
    made from a key, whatever the generator."""

    def __init__(self, jbase, draws):
        super().__init__(torch.from_numpy(np.array(jbase.loc)),
                         torch.from_numpy(np.array(jbase.scale)))
        self.draws = torch.from_numpy(np.array(draws))

    def sample(self, generator, sample_shape=()):
        return self.draws.reshape(tuple(sample_shape) + (-1,))


def _setup(dt, key):
    jdt, tdt, _ = DT[dt]
    rng = np.random.default_rng(1)
    jflow = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        nf.realnvp(jax.random.key(0), 2, (8, 8), 2, jdt))
    tflow = load_jax_params(
        nft.realnvp(torch.Generator(), 2, (8, 8), 2, tdt, device="cpu"),
        jax_arrays(jflow))
    tflow.base = _Given(jflow.base, jflow.base.sample(key, (N,)))
    return jflow, tflow, nf.Banana(2, 1.0, 10.0), nft.Banana(2, 1.0, 10.0)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_estimators_match_jax(dt):
    key = jax.random.key(3)
    jflow, tflow, jt, tt = _setup(dt, key)
    g = torch.Generator()
    tol, etol = TOL[dt], EXP_TOL[dt]
    with torch.no_grad():
        lw = nft.log_weights(g, tflow, tt.log_prob, N)
        _close(lw, nf.log_weights(key, jflow, jt.log_prob, N), tol)
        (m, sem), (jm, jsem) = (nft.elbo_with_sem(g, tflow, tt.log_prob, N),
                                nf.elbo_with_sem(key, jflow, jt.log_prob, N))
        _close(m, jm, tol)
        _close(sem, jsem, tol)
        # ddof 1
        _close(sem, lw.std(correction=1) / np.sqrt(N), (1e-12, 0))
        _close(nft.log_normalizer(g, tflow, tt.log_prob, N),
               nf.log_normalizer(key, jflow, jt.log_prob, N), etol)
        for normalize in (True, False):
            _close(nft.ess(g, tflow, tt.log_prob, N, normalize),
                   nf.ess(key, jflow, jt.log_prob, N, normalize), etol)
        rep = nft.evaluate_flow(g, tflow, tt.log_prob, N)
    jrep = nf.evaluate_flow(key, jflow, jt.log_prob, N)
    assert isinstance(rep, nft.FlowDiagnostics)
    assert rep._fields == jrep._fields and rep.n_samples == N
    for name in ("elbo", "elbo_sem"):
        _close(getattr(rep, name), getattr(jrep, name), tol, name)
    for name in ("log_normalizer", "ess"):
        _close(getattr(rep, name), getattr(jrep, name), etol, name)
    assert 0 < float(rep.ess) <= 1


def test_estimators_draw_from_the_generator():
    """The public functions draw their samples from the generator passed
    in: one seed, one answer, on the flow's device and dtype."""
    flow = nft.realnvp(torch.Generator().manual_seed(0), 2, (8,), 2,
                       torch.float64, device="cpu")
    t = nft.Banana(2, 1.0, 10.0)
    with torch.no_grad():
        a = nft.evaluate_flow(torch.Generator().manual_seed(5), flow,
                              t.log_prob, 256)
        b = nft.evaluate_flow(torch.Generator().manual_seed(5), flow,
                              t.log_prob, 256)
        c = nft.evaluate_flow(torch.Generator().manual_seed(6), flow,
                              t.log_prob, 256)
        lw = nft.log_weights(torch.Generator().manual_seed(5), flow,
                             t.log_prob, 256)
    assert a.elbo == b.elbo and a.ess == b.ess and a.elbo != c.elbo
    assert a.elbo.dtype == torch.float64 and a.elbo == lw.mean()


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("dim,n_proj", [(2, 128), (5, 16)])
def test_sliced_wasserstein2_matches_jax(dim, n_proj, dt):
    jdt, tdt, ndt = DT[dt]
    rng = np.random.default_rng(dim)
    xs = rng.standard_normal((300, dim)).astype(ndt)
    ys = (1.3 * rng.standard_normal((300, dim)) + 0.2).astype(ndt)
    key = jax.random.key(7)
    want = nf.sliced_wasserstein2(key, jnp.asarray(xs), jnp.asarray(ys),
                                  n_proj)
    theta = np.array(jax.random.normal(key, (n_proj, dim), jdt))
    got = diagnostics._sliced_w2(torch.from_numpy(xs), torch.from_numpy(ys),
                                 torch.from_numpy(theta))
    _close(got, want, TOL[dt])
    # the public entry draws its directions from the generator
    g = torch.Generator().manual_seed(1)
    pub = nft.sliced_wasserstein2(g, torch.from_numpy(xs),
                                  torch.from_numpy(ys), n_proj)
    theta = torch.randn((n_proj, dim), generator=torch.Generator(
    ).manual_seed(1), dtype=tdt)
    assert pub == diagnostics._sliced_w2(torch.from_numpy(xs),
                                         torch.from_numpy(ys), theta)
    assert float(nft.sliced_wasserstein2(g, torch.from_numpy(xs),
                                         torch.from_numpy(xs))) == 0.0
    with pytest.raises(ValueError, match="must match"):
        nft.sliced_wasserstein2(g, torch.from_numpy(xs),
                                torch.from_numpy(ys[:10]))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("bins,lims", [(64, None), (8, None),
                                       (16, (-2.0, 2.0, -1.5, 3.0))])
def test_grid_total_variation_matches_jax(bins, lims, dt):
    """Bins by truncation and clip: the lims case puts samples outside the
    grid on both sides, which clip into the edge bins."""
    ndt = DT[dt][2]
    rng = np.random.default_rng(bins)
    xs = (1.5 * rng.standard_normal((400, 2))).astype(ndt)
    ys = (rng.standard_normal((500, 2)) * [1.0, 2.0] + [0.3, 0.5]).astype(
        ndt)
    want = nf.grid_total_variation(jnp.asarray(xs), jnp.asarray(ys), bins,
                                   lims)
    got = nft.grid_total_variation(torch.from_numpy(xs), torch.from_numpy(ys),
                                   bins, lims)
    assert got.dtype == DT[dt][1]
    _close(got, want, TOL[dt])
    same = nft.grid_total_variation(torch.from_numpy(xs),
                                    torch.from_numpy(xs), bins, lims)
    assert float(same) == 0.0
    with pytest.raises(ValueError, match="2-D only"):
        nft.grid_total_variation(torch.zeros((4, 3)), torch.zeros((4, 3)))
