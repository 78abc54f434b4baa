"""The port's density path against the JAX package: the inverse direction's
closed-form backward, the layout entries of the RQS module, `log_prob` and
`loglikelihood` gradients, `elbo_stl` / `elbo_iw`, `train_flow_mle` with
its data loader, and the device default of the constructors.

The JAX side runs its Pallas kernels as its own tests do: `interpret=True`
under `jax.jit`. On the CPU the port runs the kernels' plain versions (K3's
is `tile_bwd_analytic_inverse`); the CUDA kernels are held against those on
the card by chip_smoke.py.

Tolerances:
* kernels, f32: tests/test_rqs_kernel.py's (values rtol/atol 1e-5, log-dets
  rtol 1e-4 atol 1e-5, gradients rtol 2e-3 atol 1e-4); f64: 1e-9 (atol
  1e-10), the same differences at f64 precision.
* against the JAX elem-major backward, which differentiates a `jax.vjp`
  tape: tests/test_rqs_kernel.py::test_analytic_backward_matches_vjp_tape's
  f64 tolerance, 1e-10 inverse and 1e-12 forward (the implicit-function
  result differentiates the exact root, the tape the root's formula).
* flows, f64: rtol 1e-9 (atol 1e-9); f32 values rtol/atol 1e-4 and gradients
  rtol 2e-3 atol 1e-3, tests/test_torch_nsf.py's (4 couplings compound the
  kernel tolerances).
* 5 training steps: tests/test_torch_train.py's (f64 rtol 1e-8 atol 1e-12,
  f32 rtol 1e-4 atol 1e-5).
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.ops import rqs_pallas  # noqa: E402
from normalizingflows.jl_tpu.utils import data as jax_data  # noqa: E402
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.models.nets import Dense  # noqa: E402
from normalizingflows_torch.ops import rqs_cuda  # noqa: E402
from normalizingflows_torch.utils import data  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

B = 5.0      # box of the kernel-level tests
BOX = 4.0    # box of the flows (identity init + noise 0.1, ROADMAP §3)
DIM, HDIMS, NLAYERS, BATCH = 4, (8, 8), 2, 48
DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
KTOL = {"f32": dict(v=(1e-5, 1e-5), ld=(1e-4, 1e-5), g=(2e-3, 1e-4)),
        "f64": dict(v=(1e-9, 1e-10), ld=(1e-9, 1e-10), g=(1e-9, 1e-10))}
FTOL = {"f32": dict(v=(1e-4, 1e-4), g=(2e-3, 1e-3)),
        "f64": dict(v=(1e-9, 1e-9), g=(1e-9, 1e-9))}
TRAIN_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-8, 1e-12)}


def _close(a, b, tol, **kw):
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol[0], atol=tol[1],
                               **kw)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _inputs(dt, K, seed, n=200, P=None):
    """x over [−1.5B, 1.5B] kept 1e-2 away from ±B (where analytic and tape
    backwards take different subgradients), raw ~ 0.5·N(0, 1) in P ≥ 3K−1
    columns (tests/test_rqs_kernel.py's draws)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5 * B, 1.5 * B, n)
    x = np.where(np.abs(np.abs(x) - B) < 1e-2, 0.9 * x, x)
    raw = 0.5 * rng.normal(size=(n, P or 3 * K - 1))
    return x.astype(DT[dt][2]), raw.astype(DT[dt][2])


# (a) --------------------------------------------------------------------

@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_plain_inverse_backward_matches_pallas_grad(dt, K):
    """`tile_bwd_analytic_inverse` against `jax.grad` through the Pallas
    kernel's inverse direction, whose VJP is `_tile_bwd_analytic_inverse`
    in interpret mode."""
    x, raw = _inputs(dt, K, seed=31 + K)

    def loss(x, raw_t):
        y, ld = rqs_pallas.rqs_fused_t(x, raw_t, B, True, True)
        return jnp.sum(jnp.sin(y)) + jnp.sum(0.5 * ld)

    gx_j, graw_t_j = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(raw.T))
    xt, rt = _t(x), _t(raw)
    y, _ = rqs_cuda.tile_transform(xt, rt, B, inverse=True)
    gx, graw = rqs_cuda.tile_bwd_analytic_inverse(
        xt, rt, torch.cos(y), torch.full_like(y, 0.5), B)
    assert graw.dtype == DT[dt][1] and graw.shape == rt.shape
    _close(gx, gx_j, KTOL[dt]["g"])
    _close(graw, np.asarray(graw_t_j).T, KTOL[dt]["g"])


@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_plain_inverse_backward_matches_autograd(dt, K):
    """The implicit-function VJP against torch autograd through the port's
    own plain inverse tile, which differentiates the root's formula."""
    x, raw = _inputs(dt, K, seed=37 + K)
    xt = _t(x).requires_grad_()
    rt = _t(raw).requires_grad_()
    y, ld = rqs_cuda.tile_transform(xt, rt, B, inverse=True)
    gy, gld = torch.cos(y.detach()), torch.full_like(ld, 0.5)
    gx_a, graw_a = torch.autograd.grad((y, ld), (xt, rt), (gy, gld))
    gx, graw = rqs_cuda.tile_bwd_analytic_inverse(
        xt.detach(), rt.detach(), gy, gld, B)
    _close(gx, gx_a, KTOL[dt]["g"])
    _close(graw, graw_a, KTOL[dt]["g"])


# (b) --------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dt,K", [("f32", 8), ("f64", 10)])
def test_padded_elem_major_matches_jax(dt, K, inverse):
    """`rqs_fused_e` on (N, P = 3K−1+3): values and both gradients against
    JAX `rqs_fused_e`; the pad columns' gradient is exactly 0 and the other
    columns equal the unpadded call's bit for bit."""
    P0 = 3 * K - 1
    x, raw = _inputs(dt, K, seed=41 + K + inverse, P=P0 + 3)

    def loss_j(x, raw_e):
        y, ld = rqs_pallas.rqs_fused_e(x, raw_e, B, K, inverse, True)
        return jnp.sum(jnp.sin(y)) + jnp.sum(0.5 * ld), (y, ld)

    (_, (y_j, ld_j)), (gx_j, graw_j) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                               jnp.asarray(raw))

    def loss_t(raw_e, fused):
        xt = _t(x).requires_grad_()
        re = raw_e.requires_grad_()
        y, ld = fused(xt, re)
        g = torch.autograd.grad(torch.sin(y).sum() + (0.5 * ld).sum(),
                                (xt, re))
        return y, ld, g

    y, ld, (gx, graw) = loss_t(_t(raw), lambda x, r: rqs_cuda.rqs_fused_e(
        x, r, B, K, inverse))
    tol = KTOL[dt]
    _close(y, y_j, tol["v"])
    _close(ld, ld_j, tol["ld"])
    gtol = tol["g"] if dt == "f32" else (1e-10,) * 2 if inverse else \
        (1e-12,) * 2
    _close(gx, gx_j, gtol)
    _close(graw, graw_j, gtol)
    assert graw.shape == (x.shape[0], P0 + 3)
    assert torch.count_nonzero(graw[:, P0:]) == 0
    assert not np.asarray(graw_j)[:, P0:].any()

    y_u, ld_u, (gx_u, graw_u) = loss_t(
        _t(raw[:, :P0]), lambda x, r: rqs_cuda.rqs_fused(x, r, B, inverse))
    assert torch.equal(y, y_u) and torch.equal(ld, ld_u)
    assert torch.equal(gx, gx_u) and torch.equal(graw[:, :P0], graw_u)


# (c) --------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_rows_view_matches_jax_rows_kernel(dt, inverse):
    """The Pallas rows layout (`_call_fwd_rows`: x (R, N/R), raw_t
    (3K−1, R, N/R), R=8, L=128) is `rqs_fused_t` over the flattened views
    of those tensors, and `rqs_fused` over the (R, N/R, 3K−1) permuted view
    is the same call."""
    K, R, L = 10, 8, 128
    P, n = 3 * K - 1, 2 * R * L
    x, raw = _inputs(dt, K, seed=53 + inverse, n=n)
    raw_t = np.ascontiguousarray(raw.T)
    y_j, ld_j = jax.jit(lambda x, r: rqs_pallas._call_fwd_rows(
        x, r, B, K, inverse, True, L, R))(jnp.asarray(x), jnp.asarray(raw_t))

    x_rows = _t(x).reshape(R, n // R)
    raw_rows = _t(raw_t).reshape(P, R, n // R)
    y, ld = rqs_cuda.rqs_fused_t(x_rows.reshape(-1), raw_rows.reshape(P, -1),
                                 B, inverse)
    _close(y, y_j, KTOL[dt]["v"])
    _close(ld, ld_j, KTOL[dt]["ld"])
    y_v, ld_v = rqs_cuda.rqs_fused(x_rows, raw_rows.permute(1, 2, 0), B,
                                   inverse)
    assert torch.equal(y_v.reshape(-1), y) and torch.equal(ld_v.reshape(-1),
                                                           ld)


def test_param_major_gradient_comes_back_param_major():
    """`rqs_fused_t`'s raw gradient has raw_t's shape and equals the
    elem-major call's, transposed, in both directions."""
    K = 8
    x, raw = _inputs("f64", K, seed=59)
    for inverse in (False, True):
        grads = []
        for raw_in, fused in (
                (_t(raw), lambda x, r: rqs_cuda.rqs_fused(x, r, B, inverse)),
                (_t(raw.T), lambda x, r: rqs_cuda.rqs_fused_t(x, r, B,
                                                              inverse))):
            xt, r = _t(x).requires_grad_(), raw_in.requires_grad_()
            y, ld = fused(xt, r)
            grads.append(torch.autograd.grad(y.sum() + ld.sum(), (xt, r)))
        assert grads[1][1].shape == (3 * K - 1, x.shape[0])
        assert torch.equal(grads[0][0], grads[1][0])
        assert torch.equal(grads[0][1], grads[1][1].T)


# flows ------------------------------------------------------------------

def _pair(dt, K, backend, seed=0):
    """A JAX nsf at identity init moved off it by noise 0.1 on every
    parameter, and the port's copy of it on the CPU."""
    jdt, tdt, _ = DT[dt]
    jflow = nf.nsf(jax.random.key(seed), DIM, HDIMS, K=K, B=BOX,
                   nlayers=NLAYERS, dtype=jdt, backend=backend,
                   interpret=True, identity_init=True)
    rng = np.random.default_rng(seed + 1)
    jflow = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                        a.dtype), jflow)
    tflow = nft.nsf(torch.Generator().manual_seed(seed), DIM, HDIMS, K=K,
                    B=BOX, nlayers=NLAYERS, dtype=tdt, device="cpu")
    load_jax_params(tflow, jax_arrays(jflow))
    return jflow, tflow


def _grads_of(tflow, jgrads, names):
    """JAX's gradient pytree on the port's parameter names."""
    ref = dict(load_jax_params(copy.deepcopy(tflow),
                               jax_arrays(jgrads)).named_parameters())
    return {n: ref[n].detach().numpy() for n in names}


# (d) --------------------------------------------------------------------

@pytest.mark.parametrize("dt,K,backend", [
    ("f32", 10, "pallas"), ("f64", 8, "pallas"), ("f64", 10, "oracle")])
def test_log_prob_and_loglikelihood_gradients_match_jax(dt, K, backend):
    """`log_prob` values, and `loglikelihood`'s value and the gradient of
    every parameter (conditioners and base), against `jax.grad` through
    the Pallas kernel's implicit-function VJP or autodiff of the oracle."""
    jflow, tflow = _pair(dt, K, backend, seed=K)
    rng = np.random.default_rng(61)
    y = (2.0 * rng.standard_normal((BATCH, DIM))).astype(DT[dt][2])
    _close(tflow.log_prob(_t(y)), jax.jit(jflow.log_prob)(jnp.asarray(y)),
           FTOL[dt]["v"])

    val_j, grads_j = jax.jit(jax.value_and_grad(
        lambda f: nf.loglikelihood(f, jnp.asarray(y))))(jflow)
    val_t = nft.loglikelihood(tflow, _t(y))
    val_t.backward()
    _close(val_t, val_j, FTOL[dt]["v"])
    names = [n for n, _ in tflow.named_parameters()]
    assert len(names) == 2 * NLAYERS * 2 * (len(HDIMS) + 1) + 2
    ref = _grads_of(tflow, grads_j, names)
    for name, p in tflow.named_parameters():
        _close(p.grad, ref[name], FTOL[dt]["g"], err_msg=name)


class _GivenDraws(nft.DiagNormal):
    """The flow's base with its parameters, whose `sample` hands back given
    draws: the JAX package's draws reach the port's estimator."""

    def __init__(self, base, draws):
        super().__init__(base.loc.detach().clone(),
                         base.scale.detach().clone())
        self.draws = draws

    def sample(self, generator, sample_shape=()):
        assert tuple(sample_shape) + (self.event_dim,) == self.draws.shape
        return self.draws


# (e) --------------------------------------------------------------------

@pytest.mark.parametrize("objective,dt,backend", [
    ("stl", "f64", "pallas"), ("stl", "f32", "pallas"),
    ("iw", "f64", "oracle"), ("iw", "f32", "pallas")])
def test_stl_and_iw_match_jax(objective, dt, backend):
    """`elbo_stl` and `elbo_iw`: value and the gradient of every
    conditioner parameter against `jax.value_and_grad`, on the JAX
    estimator's own draws. (The base's gradient differs by design: JAX's
    reaches loc/scale through its reparameterised draws, which the port is
    handed as constants.)"""
    n, n_particles = 32, 4
    jflow, tflow = _pair(dt, 10, backend, seed=3)
    key = jax.random.key(5)
    jt, tt = nf.Banana(DIM, 1.0, 10.0), nft.Banana(DIM, 1.0, 10.0)
    if objective == "stl":
        shape, args, jobj, tobj = (n,), (n,), nf.elbo_stl, nft.elbo_stl
    else:
        shape, args = (n_particles, n), (n, n_particles)
        jobj, tobj = nf.elbo_iw, nft.elbo_iw
    draws = np.asarray(jax.jit(lambda k: jflow.base.sample(k, shape))(key))
    tflow.base = _GivenDraws(tflow.base, _t(draws))

    val_j, grads_j = jax.jit(jax.value_and_grad(
        lambda f: jobj(key, f, jt.log_prob, *args)))(jflow)
    val_t = tobj(torch.Generator(), tflow, tt.log_prob, *args)
    val_t.backward()
    _close(val_t, val_j, FTOL[dt]["v"])
    names = [n for n, _ in tflow.named_parameters() if ".W" in n or ".b" in n]
    assert len(names) == 2 * NLAYERS * 2 * (len(HDIMS) + 1)
    ref = _grads_of(tflow, grads_j, names)
    for name in names:
        p = tflow.get_parameter(name)
        _close(p.grad, ref[name], FTOL[dt]["g"], err_msg=name)


def test_stl_gradient_is_the_path_derivative_only():
    """STL has `elbo_batch`'s value; its gradient leaves out the score term
    E[∇θ log q], which the plain reparameterised gradient keeps. On the
    same draws the two gradients differ, and `elbo_stl` equals the plain
    gradient of logp(T(x)) − log q_θ̄(T_θ(x)) with θ̄ a frozen copy (to
    rounding: autograd accumulates the same terms in another order)."""
    _, tflow = _pair("f64", 8, "oracle", seed=7)
    draws = _t(np.random.default_rng(9).standard_normal((32, DIM)))
    tflow.base = _GivenDraws(tflow.base, draws)
    tt = nft.Banana(DIM, 1.0, 10.0)
    g = torch.Generator()

    def grads(fn, flow):
        flow.zero_grad()
        val = fn(flow)
        val.backward()
        return val, [p.grad.clone() for p in flow.bijector.parameters()]

    v_stl, g_stl = grads(lambda f: nft.elbo_stl(g, f, tt.log_prob, 32), tflow)
    v_b, g_b = grads(lambda f: nft.elbo_batch(g, f, tt.log_prob, 32), tflow)
    _close(v_stl, v_b.detach().numpy(), (1e-9, 1e-9))
    assert max(float((a - b).abs().max()) for a, b in zip(g_stl, g_b)) > 1e-3

    frozen = copy.deepcopy(tflow).requires_grad_(False)

    def by_hand(f):
        ys, _ = f.bijector.forward_and_log_det(draws)
        return (tt.log_prob(ys) - frozen.log_prob(ys)).mean()

    _, g_ref = grads(by_hand, tflow)
    for a, b in zip(g_stl, g_ref):  # the same sums, accumulated apart
        _close(a, b.numpy(), (1e-12, 1e-14))


# (f) --------------------------------------------------------------------

def test_numpy_loader_gives_the_jax_batches():
    """The port's `NumpyLoader` yields the JAX package's batches from the
    same seed, across epoch boundaries (a batch that does not divide the
    rows), through `next` and `next_batches` alike."""
    arr = np.random.default_rng(0).standard_normal((50, 3))
    ours, theirs = data.make_loader(arr, 16, seed=4), \
        jax_data.make_loader(arr, 16, seed=4)
    for _ in range(3):
        np.testing.assert_array_equal(next(ours), next(theirs))
        b_ours, b_theirs = ours.next_batches(5), theirs.next_batches(5)
        assert b_ours.dtype == np.float32 and b_ours.shape == (5, 16, 3)
        np.testing.assert_array_equal(b_ours, b_theirs)
    assert ours.epoch == theirs.epoch > 0


def test_make_loader_files(tmp_path, monkeypatch):
    """.npy and single-array .npz load (the npz handle is closed); an npz
    of two arrays raises; `to_raw_file` writes the JAX package's bytes,
    which load through the native loader."""
    arr = np.arange(24, dtype=np.float32).reshape(8, 3)
    np.save(tmp_path / "a.npy", arr)
    np.savez(tmp_path / "one.npz", x=arr)
    np.savez(tmp_path / "two.npz", x=arr, y=arr)
    opened = []
    real_load = np.load

    def spy(*a, **kw):
        opened.append(real_load(*a, **kw))
        return opened[-1]

    monkeypatch.setattr(np, "load", spy)
    for name in ("a.npy", "one.npz"):
        loader = data.make_loader(str(tmp_path / name), 8, seed=1)
        np.testing.assert_array_equal(np.sort(next(loader), axis=0), arr)
    assert opened[-1].zip is None  # the npz was closed
    with pytest.raises(ValueError, match="2 arrays"):
        data.make_loader(tmp_path / "two.npz", 4)
    assert opened[-1].zip is None
    raw = data.to_raw_file(str(tmp_path / "a.f32"), arr)
    jax_data.to_raw_file(str(tmp_path / "b.f32"), arr)
    assert (tmp_path / "a.f32").read_bytes() == \
        (tmp_path / "b.f32").read_bytes()
    loader = data.make_loader(raw, 8, n_rows=8, dim=3, seed=1)
    assert isinstance(loader, data.NativeLoader)
    np.testing.assert_array_equal(np.sort(next(loader), axis=0), arr)
    loader.close()


class _AsDtype:
    """A loader whose chunks come in another dtype."""

    def __init__(self, loader, dtype):
        self.loader, self.dtype = loader, dtype

    def next_batches(self, k):
        return self.loader.next_batches(k).astype(self.dtype)


@pytest.mark.parametrize("dt,backend", [("f64", "pallas"), ("f32", "oracle")])
def test_train_flow_mle_matches_jax(dt, backend):
    """5 Adam steps of `train_flow_mle` (chunks of 2) against JAX
    `train_flow_mle`, both fed by `make_loader(array, batch, seed)`:
    per-step losses and final parameters. The loaders yield float32; the
    port casts each chunk to the flow's dtype, and the JAX side is handed
    the same cast (its kernel would otherwise run a float32 x in float32)."""
    steps, batch, lr = 5, 32, 1e-3
    jflow, tflow = _pair(dt, 10, backend, seed=11)
    arr = np.asarray(nf.Banana(DIM, 1.0, 10.0).sample(jax.random.key(2),
                                                      (100,)))
    jloader = _AsDtype(jax_data.make_loader(arr, batch, seed=6), DT[dt][2])
    jres = nf.train_flow_mle(jflow, jloader, max_iters=steps,
                             optimizer=optax.adam(lr), check_every=2)
    tres = nft.train_flow_mle(
        tflow, data.make_loader(arr, batch, seed=6), max_iters=steps,
        optimizer=lambda p: torch.optim.Adam(p, lr=lr), check_every=2)
    rtol, atol = TRAIN_TOL[dt]
    np.testing.assert_allclose(tres.stats["loss"], jres.stats["loss"],
                               rtol=rtol, atol=atol)
    np.testing.assert_array_equal(tres.stats["iteration"], np.arange(1, 6))
    ref = dict(load_jax_params(copy.deepcopy(tflow),
                               jax_arrays(jres.flow)).named_parameters())
    for name, p in tres.flow.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)
    assert not tflow.base.loc.requires_grad  # the base stayed frozen


# (g) --------------------------------------------------------------------

_CONSTRUCTORS = {
    "nsf": lambda g, **kw: nft.nsf(g, 2, (4,), nlayers=1, **kw),
    "NSF_layer": lambda g, **kw: nft.NSF_layer(g, 2, (4,), 8, 3.0, **kw)[0],
    "NeuralSplineCoupling": lambda g, **kw: nft.NeuralSplineCoupling.make(
        g, 3, (4,), 8, 3.0, (0, 2), **kw),
    "fnn": lambda g, **kw: nft.fnn(g, 2, (4,), 3, **kw),
    "Dense": lambda g, **kw: Dense.make(g, 2, 3, **kw),
    "DiagNormal": lambda g, **kw: nft.DiagNormal.standard(2, **kw),
    "StandardNormal": lambda g, **kw: nft.StandardNormal(2, **kw),
}


def _device_of(obj):
    params = list(obj.parameters())
    return params[0].device if params else obj.device


@pytest.mark.parametrize("name", sorted(_CONSTRUCTORS))
def test_constructors_build_on_the_card_unless_asked(name):
    """``device=None`` is the card: where there is no CUDA device the call
    raises instead of building on the CPU; ``device="cpu"`` builds there."""
    build = _CONSTRUCTORS[name]
    g = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        assert _device_of(build(g)).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(g)
    assert _device_of(build(g, device="cpu")).type == "cpu"
