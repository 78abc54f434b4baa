"""The port's annealed training against the JAX package: `tempered`,
`train_flow_annealed`, and the mean-field `Shift` / `Scale` bijectors.

Tolerances: `tempered` and the bijectors in f64 rtol 1e-9 / 1e-12 (the
same arithmetic in another library). `train_flow_annealed` on the same
draws: `tests/test_torch_train.py`'s training tolerances, f64 rtol 1e-8
(atol 1e-12) and f32 rtol 1e-4 (atol 1e-5), on per-step losses and final
parameters; the β column and the iterations exactly. The far-target run is
`tests/test_annealed.py`'s, on the port.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

DIM, N, LR = 2, 16, 2e-2
DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": (1e-4, 1e-5), "f64": (1e-8, 1e-12)}


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _meanfield(dt, a=None, b=None, loc=None):
    """The JAX mean-field flow (`tests/test_annealed.py:15-20`), scale
    ``a`` and shift ``b`` (default 1 and 0), its base's mean ``loc``
    (default 0), and the port's copy of it."""
    jdt, tdt, ndt = DT[dt]
    a = np.ones(DIM, ndt) if a is None else np.asarray(a, ndt)
    b = np.zeros(DIM, ndt) if b is None else np.asarray(b, ndt)
    loc = np.zeros(DIM, ndt) if loc is None else np.asarray(loc, ndt)
    jflow = nf.create_flow(
        [nf.Scale(jnp.asarray(a)), nf.Shift(jnp.asarray(b))],
        nf.DiagNormal(jnp.asarray(loc), jnp.ones(DIM, jdt)))
    tflow = nft.create_flow(
        [nft.Scale(torch.ones(DIM, dtype=tdt)),
         nft.Shift(torch.zeros(DIM, dtype=tdt))],
        nft.DiagNormal.standard(DIM, tdt, device="cpu"))
    load_jax_params(tflow, jax_arrays(jflow))
    return jflow, tflow


def _targets(dt):
    jdt, tdt, _ = DT[dt]
    jt = nf.DiagNormal(jnp.full((DIM,), 30.0, jdt),
                       jnp.full((DIM,), 0.5, jdt))
    tt = nft.DiagNormal(torch.full((DIM,), 30.0, dtype=tdt),
                        torch.full((DIM,), 0.5, dtype=tdt))
    return jt, tt.requires_grad_(False)


def _jax_objective(xs, flow, logp, n):
    return nf.elbo_from_samples(xs, flow, logp)


def _port_objective(xs, flow, logp, n):
    return nft.elbo_from_samples(xs, flow, logp)


def test_shift_and_scale_match_jax():
    """A negative scale too: the log-det takes log|a|."""
    jflow, tflow = _meanfield("f64", a=[1.5, -0.25], b=[0.3, -2.0])
    x = np.random.default_rng(0).standard_normal((7, DIM))
    for jb, tb in zip(jflow.bijector.bijectors, tflow.bijector.bijectors):
        for way in ("forward_and_log_det", "inverse_and_log_det"):
            jy, jld = getattr(jb, way)(jnp.asarray(x))
            ty, tld = getattr(tb, way)(torch.from_numpy(x))
            np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=1e-12)
            np.testing.assert_allclose(tld.detach().numpy(), jld,
                                       rtol=1e-12, atol=1e-15)
    lp = tflow.log_prob(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(lp, jflow.log_prob(jnp.asarray(x)),
                               rtol=1e-12)


@pytest.mark.parametrize("beta", [0.0, 0.375, 1.0])
def test_tempered_matches_jax(beta):
    jflow, tflow = _meanfield("f64", a=[1.2, 0.7], b=[0.5, -0.4])
    jt, tt = _targets("f64")
    xs = np.random.default_rng(1).standard_normal((64, DIM))
    jv = nf.tempered(_jax_objective, jflow.base.log_prob)(
        jnp.asarray(xs), jflow, jt.log_prob, 64, jnp.asarray(beta))
    with torch.no_grad():
        tv = nft.tempered(_port_objective, tflow.base.log_prob)(
            torch.from_numpy(xs), tflow, tt.log_prob, 64,
            torch.tensor(beta, dtype=torch.float64))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-9)
    if beta == 1.0:  # β=1 is the plain objective
        with torch.no_grad():
            plain = nft.elbo_from_samples(torch.from_numpy(xs), tflow,
                                          tt.log_prob)
        np.testing.assert_allclose(float(tv), float(plain), rtol=1e-12)


def _annealed_draws(key, dt, segments, check_every):
    """The draws JAX `train_flow_annealed` makes with ``scan_inputs``
    below: a split of the key a segment, then one a chunk."""
    out = []
    for iters in segments:
        key, seg = jax.random.split(key)
        done = 0
        while done < iters:
            chunk = min(check_every, iters - done)
            seg, sub = jax.random.split(seg)
            out.append(np.asarray(jax.random.normal(sub, (chunk, N, DIM),
                                                    DT[dt][0])))
            done += chunk
    return np.concatenate(out)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_train_flow_annealed_matches_jax(dt):
    jflow, tflow = _meanfield(dt, a=[1.1, 0.9], b=[0.2, -0.1])
    jt, tt = _targets(dt)
    key, jdt = jax.random.key(3), DT[dt][0]
    kw = dict(n_betas=3, iters_per_beta=4, final_iters=3, check_every=3)
    jres = nf.train_flow_annealed(
        key, _jax_objective, jflow, jt.log_prob, N,
        optimizer=optax.adam(LR),
        scan_inputs=lambda k, f, n: jax.random.normal(k, (n, N, DIM), jdt),
        **kw)
    draws = torch.from_numpy(_annealed_draws(key, dt, (4, 4, 3), 3))
    pos = [0]

    def presampled(generator, flow, chunk):
        pos[0] += chunk
        return draws[pos[0] - chunk:pos[0]]

    res = nft.train_flow_annealed(
        torch.Generator(), _port_objective, tflow, tt.log_prob, N,
        optimizer=lambda p: torch.optim.Adam(p, lr=LR),
        scan_inputs=presampled, **kw)
    assert pos[0] == len(draws) == 11
    rtol, atol = TOL[dt]
    np.testing.assert_array_equal(res.stats["iteration"], np.arange(1, 12))
    np.testing.assert_array_equal(res.stats["iteration"],
                                  jres.stats["iteration"])
    np.testing.assert_array_equal(res.stats["beta"], jres.stats["beta"])
    np.testing.assert_allclose(res.stats["loss"], jres.stats["loss"],
                               rtol=rtol, atol=atol)
    assert res.state.iteration == 11 and res.flow is tflow
    ref = dict(load_jax_params(_meanfield(dt)[1],
                               jax_arrays(jres.flow)).named_parameters())
    for name, p in tflow.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def _annealed_pair(dt, key, jflow, tflow, train_base, resume=None,
                   segments=(4, 4, 3)):
    """JAX `train_flow_annealed` on ``jflow`` and the port's on ``tflow``
    with the same draws: (JAX result, port result). ``resume`` is a pair
    of states to resume from."""
    jt, tt = _targets(dt)
    jdt = DT[dt][0]
    kw = dict(n_betas=len(segments), iters_per_beta=segments[0],
              final_iters=segments[-1], check_every=3,
              train_base=train_base)
    jres = nf.train_flow_annealed(
        key, _jax_objective, jflow, jt.log_prob, N,
        optimizer=optax.adam(LR),
        scan_inputs=lambda k, f, n: jax.random.normal(k, (n, N, DIM), jdt),
        resume_state=None if resume is None else resume[0], **kw)
    draws = torch.from_numpy(_annealed_draws(key, dt, segments, 3))
    pos = [0]

    def presampled(generator, flow, chunk):
        pos[0] += chunk
        return draws[pos[0] - chunk:pos[0]]

    res = nft.train_flow_annealed(
        torch.Generator(), _port_objective, tflow, tt.log_prob, N,
        optimizer=lambda p: torch.optim.Adam(p, lr=LR),
        scan_inputs=presampled,
        resume_state=None if resume is None else resume[1], **kw)
    assert pos[0] == len(draws) == sum(segments)
    return jres, res


def _same_run(jres, res, dt):
    rtol, atol = TOL[dt]
    np.testing.assert_array_equal(res.stats["beta"], jres.stats["beta"])
    np.testing.assert_allclose(res.stats["loss"], jres.stats["loss"],
                               rtol=rtol, atol=atol)
    ref = dict(load_jax_params(_meanfield(dt)[1],
                               jax_arrays(jres.flow)).named_parameters())
    for name, p in res.flow.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_train_flow_annealed_trains_the_base_as_jax_does(dt):
    """``train_base=True``: the base trains, and the tempered path's q_ref
    stays the base as passed in, as JAX's (bound on an immutable pytree)
    does; a q_ref that followed the live base would change the path and
    send gradient into the base through (1−β)·log q_ref."""
    jflow, tflow = _meanfield(dt, a=[1.1, 0.9], b=[0.2, -0.1],
                              loc=[0.5, -0.3])
    start = tflow.base.loc.detach().clone()
    jres, res = _annealed_pair(dt, jax.random.key(4), jflow, tflow, True)
    assert not torch.equal(res.flow.base.loc.detach(), start)
    assert all(p.requires_grad for p in res.flow.parameters())
    _same_run(jres, res, dt)


def test_train_flow_annealed_resumes_with_the_arguments_base():
    """On resume, q_ref is the ``flow`` argument's base, not the resumed
    state's (which a first run with ``train_base=True`` has moved)."""
    dt = "f64"
    jflow, tflow = _meanfield(dt, a=[1.1, 0.9], b=[0.2, -0.1],
                              loc=[0.5, -0.3])
    jfirst, first = _annealed_pair(dt, jax.random.key(5), jflow, tflow,
                                   True, segments=(3, 3))
    _same_run(jfirst, first, dt)
    _, argument = _meanfield(dt, a=[1.1, 0.9], b=[0.2, -0.1],
                             loc=[0.5, -0.3])
    jres, res = _annealed_pair(dt, jax.random.key(6), jflow, argument, True,
                               resume=(jfirst.state, first.state),
                               segments=(3, 3))
    assert res.flow is tflow and res.state.iteration == 12
    np.testing.assert_array_equal(res.stats["iteration"], np.arange(7, 13))
    _same_run(jres, res, dt)


def test_annealed_reaches_far_target():
    """`tests/test_annealed.py::test_annealed_reaches_far_target` on the
    port: N(30, 0.5), about 42σ from the init, reached along the path."""
    _, tflow = _meanfield("f32")
    _, target = _targets("f32")
    g = torch.Generator().manual_seed(0)
    res = nft.train_flow_annealed(
        g, nft.elbo_batch, tflow, target.log_prob, 32, n_betas=8,
        iters_per_beta=400, final_iters=1200,
        optimizer=lambda p: torch.optim.Adam(p, lr=LR), check_every=400)
    with torch.no_grad():
        after = float(nft.elbo_batch(torch.Generator().manual_seed(9),
                                     res.flow, target.log_prob, 4096))
    assert after > -0.5, after
    shift = res.flow.bijector.bijectors[1].b.detach().numpy()
    assert np.all(np.abs(shift - 30.0) < 0.5), shift
    assert len(res.stats["beta"]) == len(res.stats["loss"]) == 8 * 400 + 800
    assert res.stats["beta"][0] == pytest.approx(1 / 8)
    assert res.stats["beta"][-1] == 1.0
