"""The port's targets against the JAX package's: `Banana`, `Funnel`,
`GaussianMixture`, `Cross` and `WarpedGauss` (normalised and
``ref_compat``).

`log_prob` and `score` on the same numpy draws, f64 rtol 1e-9 (atol
1e-12) and f32 rtol 1e-5 (atol 1e-6) for values, 1e-4 relative (atol
1e-6) for f32 gradients; each `score` also against `torch.autograd.grad`
of the port's own `log_prob`, and the autograd scores' second derivative
(what the Hamiltonian flow's backward takes) against JAX's. `sample`:
each coordinate's mean and standard deviation from 100,000 port draws
against 100,000 JAX draws, within 6 standard errors of their difference.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
import normalizingflows_torch as nft  # noqa: E402

torch.set_num_threads(1)

DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": (1e-5, 1e-6), "f64": (1e-9, 1e-12)}
GRAD_TOL = {"f32": (1e-4, 1e-6), "f64": (1e-9, 1e-12)}
N_MOMENTS = 100_000

MIX_LOCS = [[0.5, -1.0, 2.0], [-1.5, 0.0, 0.3], [1.0, 1.0, -1.0]]
MIX_SCALES = [[0.7, 1.2, 0.4], [1.1, 0.5, 0.9], [0.3, 0.8, 1.5]]
MIX_WEIGHTS = [0.2, 0.5, 0.3]


def _pair(name, dt):
    """(JAX target, the port's, input scale) for ``name``."""
    jdt, tdt, ndt = DT[dt]
    if name == "banana":
        return nf.Banana(2, 1.0, 10.0), nft.Banana(2, 1.0, 10.0), 2.0
    if name == "banana3":
        return nf.Banana(3, 0.5, 4.0), nft.Banana(3, 0.5, 4.0), 1.5
    if name == "funnel":
        return nf.Funnel(2, -8.0, 5.0), nft.Funnel(2, -8.0, 5.0), 1.5
    if name == "funnel3":
        return nf.Funnel(3), nft.Funnel(3), 1.0
    if name == "mixture":
        arrays = [np.asarray(a, ndt) for a in
                  (MIX_LOCS, MIX_SCALES, MIX_WEIGHTS)]
        return (nf.GaussianMixture(*(jnp.asarray(a) for a in arrays)),
                nft.GaussianMixture(*arrays, device="cpu"), 1.5)
    if name == "cross":
        return (nf.Cross(2.0, 0.15, jdt), nft.Cross(2.0, 0.15, tdt, "cpu"),
                2.0)
    if name == "warped":
        return nf.WarpedGauss(1.0, 0.12), nft.WarpedGauss(1.0, 0.12), 1.0
    if name == "warped_ref":
        return (nf.WarpedGauss(1.0, 0.12, ref_compat=True),
                nft.WarpedGauss(1.0, 0.12, ref_compat=True), 1.0)
    raise KeyError(name)


NAMES = ["banana", "banana3", "funnel", "funnel3", "mixture", "cross",
         "warped", "warped_ref"]


def _draws(name, dt, n=64):
    jt, tt, scale = _pair(name, dt)
    x = scale * np.random.default_rng(len(name)).standard_normal(
        (n, tt.event_dim))
    return jt, tt, x.astype(DT[dt][2])


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("name", NAMES)
def test_log_prob_matches_jax(name, dt):
    jt, tt, x = _draws(name, dt)
    want = np.asarray(jax.jit(jt.log_prob)(jnp.asarray(x)))
    got = tt.log_prob(torch.from_numpy(x))
    assert got.dtype == DT[dt][1] and got.shape == (len(x),)
    rtol, atol = TOL[dt]
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("name", NAMES)
def test_score_matches_jax_and_autograd(name, dt):
    jt, tt, x = _draws(name, dt)
    rtol, atol = GRAD_TOL[dt]
    want = np.asarray(jax.jit(jt.score)(jnp.asarray(x)))
    with torch.no_grad():  # as sampling calls it
        got = tt.score(torch.from_numpy(x))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    xt = torch.from_numpy(x).requires_grad_(True)
    (auto,) = torch.autograd.grad(tt.log_prob(xt).sum(), xt)
    np.testing.assert_allclose(got.numpy(), auto.numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("name", ["banana", "funnel", "mixture", "warped"])
def test_score_differentiates_as_jax(name, dt):
    """∇ₓ Σ score(x)·c: the autograd scores (`create_graph`) and the
    closed-form one against JAX's second derivative."""
    jt, tt, x = _draws(name, dt, n=16)
    c = np.random.default_rng(5).standard_normal(x.shape).astype(x.dtype)
    want = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(jt.score(v) * c)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    score = tt.score(xt)
    assert score.requires_grad
    (got,) = torch.autograd.grad((score * torch.from_numpy(c)).sum(), xt)
    rtol, atol = GRAD_TOL[dt]
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def _moments(x):
    x = np.asarray(x, np.float64)
    return x.mean(0), x.std(0), x.var(0)


@pytest.mark.parametrize("name", ["banana", "funnel", "cross", "mixture",
                                  "warped"])
def test_sample_moments_match_jax(name):
    """Funnel's momenta are heavy-tailed: its second coordinate is taken
    divided by exp(x₁/2), which makes it N(0, 1)."""
    jt, tt, _ = _pair(name, "f64")
    g = torch.Generator().manual_seed(11)
    if isinstance(tt, nft.GaussianMixture):
        got = tt.sample(g, (N_MOMENTS,))
    else:
        got = tt.sample(g, (N_MOMENTS,), dtype=torch.float64)
    want = np.asarray(jax.jit(lambda k: jt.sample(k, (N_MOMENTS,)))(
        jax.random.key(11)))
    assert got.shape == want.shape == (N_MOMENTS, tt.event_dim)
    assert got.dtype == torch.float64
    got = got.numpy()
    if name == "funnel":
        got = np.stack([got[:, 0], got[:, 1] * np.exp(-0.5 * got[:, 0])], 1)
        want = np.stack([want[:, 0], want[:, 1] * np.exp(-0.5 * want[:, 0])],
                        1)
    (mg, sg, vg), (mw, sw, vw) = _moments(got), _moments(want)
    se_mean = np.sqrt((vg + vw) / N_MOMENTS)
    assert np.all(np.abs(mg - mw) < 6 * se_mean), (mg, mw, se_mean)
    # the standard deviation's standard error, from the fourth moment
    k4 = [np.mean((a - a.mean(0)) ** 4, 0) for a in (got, want)]
    se_std = np.sqrt(sum((k - v * v) / (4 * v * N_MOMENTS)
                         for k, v in zip(k4, (vg, vw))))
    assert np.all(np.abs(sg - sw) < 6 * se_std), (sg, sw, se_std)


def test_targets_keep_python_floats_and_device_buffers():
    assert isinstance(nft.Funnel(2, -8, 5).mu, float)
    assert isinstance(nft.WarpedGauss(1, 0.12).sigma2, float)
    mix = nft.Cross(device="cpu")
    assert {n for n, _ in mix.named_buffers()} == {"locs", "scales",
                                                   "weights"}
    assert not list(mix.parameters())
    np.testing.assert_array_equal(mix.locs.numpy(),
                                  [[0, 2], [-2, 1], [2, 1], [0, -2]])
    with pytest.raises(ValueError):
        nft.Funnel(1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            nft.Cross()  # device=None is the card


def test_warped_gauss_default_is_normalised():
    """The area-preserving warp has unit Jacobian: the default density
    integrates to 1 on a grid, the reference's log(r) one to E[r]."""
    h = 0.01
    grid = np.arange(-4.0, 4.0, h) + h / 2
    xy = torch.from_numpy(np.stack(np.meshgrid(grid, grid), -1)
                          .reshape(-1, 2))
    target = nft.WarpedGauss(1.0, 0.12)
    draws = target.sample(torch.Generator().manual_seed(0), (N_MOMENTS,),
                          dtype=torch.float64)
    mean_r = float(draws.norm(dim=-1).mean())
    for ref_compat, want in ((False, 1.0), (True, mean_r)):
        density = nft.WarpedGauss(1.0, 0.12, ref_compat).log_prob(xy).exp()
        assert float(density.sum()) * h * h == pytest.approx(want, abs=1e-2)
