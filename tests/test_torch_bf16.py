"""bfloat16 in the port against the JAX package: the bf16 ``compute_dtype``
policy and bfloat16 parameters.

The policy (JAX `nets._mixed_matmul`, the Pallas coupling kernels'
`_dot(a, b, cd)`): parameters stay float32, a conditioner product's
operands go to bfloat16 and it sums in float32. The port keeps the float32
sum unrounded on the CPU as on the card; so does JAX under `jax.jit`
(XLA folds the source's off-TPU rounding into the dot), and the tests
compare the jitted JAX functions. The spline kernels read
bfloat16 raw under the policy; the JAX side runs them as its own tests do,
``backend="pallas", interpret=True``, which rounds raw as the port does.

bfloat16 parameters (the reference's ``paramtype``): JAX computes in
bfloat16 throughout; the port's kernels and their plain versions compute
a bfloat16 x in float32 and round each output once, and torch's bfloat16
matmuls round once where XLA may round twice (product, then bias). So the
port and JAX differ by bfloat16 roundings, about 2^-8 relative each.

Tolerances (max |a − b| ≤ atol + rtol·|b|), each measured on these inputs
and stated beside the test; none is looser than JAX's own bf16 policy
bound, 0.05 relative against float32 (tests/test_dtype_policy.py):
* `Dense` under the policy: value, gx and gW rtol/atol 1e-6 (measured at
  most 4.8e-7: the same roundings, float32 sums in other orders), gb 1e-5
  (measured 4.2e-6, a sum over 512 rows);
* policy flows against JAX: values rtol/atol 1e-4, gradients 2e-3
  (measured at most 5.7e-6 and 1.3e-3 absolute, the largest in nsf, whose
  graw is rounded to bfloat16 and where a float32 sum taken in another
  order can flip a rounding);
* bfloat16 parameters: the two packages are not one program (JAX
  computes in bfloat16), so each is held against JAX in float32 on the
  same bfloat16 weights and inputs (`_as_f32`), and the port's error must
  be no larger than JAX's own (`_no_worse`: max relative error at most
  1.5× JAX's plus 2^-8). A kernel's plain version on bfloat16 storage
  rounds the float32 value once: within 2^-8 relative of it.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu import config as jcfg  # noqa: E402
from normalizingflows.jl_tpu.experimental import (  # noqa: E402
    coupling_pallas as jax_cp,
)
from normalizingflows.jl_tpu.models.nets import Dense as JDense  # noqa: E402
from normalizingflows.jl_tpu.ops import rqs_pallas  # noqa: E402
from normalizingflows.jl_tpu.utils.pytree import (  # noqa: E402
    apply_mask,
    trainable_mask,
)
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch import config as tcfg  # noqa: E402
from normalizingflows_torch.experimental import coupling_cuda as cc  # noqa
from normalizingflows_torch.models.nets import Dense  # noqa: E402
from normalizingflows_torch.ops import launches, rqs_cuda  # noqa: E402
from normalizingflows_torch.utils import checkpoint as tck  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

BF = torch.bfloat16
DENSE_TOL, DENSE_GB_TOL = (1e-6, 1e-6), (1e-5, 1e-5)
POLICY_TOL = dict(v=(1e-4, 1e-4), g=(2e-3, 2e-3))
ONE_ROUNDING = 2.0 ** -8  # a float32 value rounded once to bfloat16


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol[0], atol=tol[1],
                               err_msg=msg)


def _perturb(tree, seed=2, sigma=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + sigma * jnp.asarray(rng.standard_normal(a.shape),
                                          a.dtype), tree)


def _draws(d, n, seed=1, scale=1.0, dtype=np.float32):
    return (scale * np.random.default_rng(seed).standard_normal(
        (n, d))).astype(dtype)


def _as_f32(tree):
    """A JAX pytree with its bfloat16 leaves widened (exactly) to float32."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        tree)


def _rel_err(a, ref):
    a, ref = _np(a).astype(np.float64), _np(ref).astype(np.float64)
    return float(np.max(np.abs(a - ref) / (np.abs(ref) + 1.0)))


def _no_worse(port, theirs, ref, what):
    """The port's bfloat16 result is no further from the float32 reference
    than JAX's bfloat16 one (1.5× its max relative error, plus 2^-8)."""
    e_port, e_jax = _rel_err(port, ref), _rel_err(theirs, ref)
    assert e_port <= 1.5 * e_jax + ONE_ROUNDING, (what, e_port, e_jax)


# ---------------------------------------------------------------------------
# Dense and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16,), (4, 16), (512, 16)])
def test_dense_policy_matches_jax(shape):
    """`Dense(compute_dtype=bfloat16)` against JAX's: the value (float32)
    and the gradients of x, W and b under one cotangent (JAX's custom VJP:
    both backward products in bfloat16)."""
    rng = np.random.default_rng(0)
    W = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[:-1] + (8,)).astype(np.float32)
    jd = JDense(jnp.asarray(W), jnp.asarray(b), None, jnp.bfloat16)
    # jitted, as the JAX package runs it (every step and scan is): XLA
    # folds the source's bfloat16 rounding of the product into the dot
    y_j = jax.jit(lambda d, a: d(a))(jd, jnp.asarray(x))
    gd, gx_j = jax.jit(jax.grad(lambda d, a: jnp.sum(d(a) * g),
                                argnums=(0, 1)))(jd, jnp.asarray(x))
    td = Dense(torch.tensor(W), torch.tensor(b), None, BF)
    xt = torch.tensor(x, requires_grad=True)
    y_t = td(xt)
    (y_t * torch.tensor(g)).sum().backward()
    assert y_t.dtype == torch.float32 and td.W.dtype == torch.float32
    _close(y_t, y_j, DENSE_TOL, "y")
    _close(xt.grad, gx_j, DENSE_TOL, "gx")
    _close(td.W.grad, gd.W, DENSE_TOL, "gW")
    _close(td.b.grad, gd.b, DENSE_GB_TOL, "gb")


def test_dense_bf16_parameters_and_checks():
    """A bfloat16 `Dense` with no policy is a plain bfloat16 matmul (JAX's
    ``precision=None`` branch); the policy takes bfloat16 only."""
    rng = np.random.default_rng(1)
    W = rng.standard_normal((16, 8)).astype(np.float32)
    x = rng.standard_normal((32, 16)).astype(np.float32)
    jd = JDense(jnp.asarray(W, jnp.bfloat16), jnp.zeros(8, jnp.bfloat16))
    td = Dense(torch.tensor(W).to(BF), torch.zeros(8, dtype=BF))
    y_t = td(torch.tensor(x).to(BF))
    assert y_t.dtype == BF
    _close(y_t, jd(jnp.asarray(x, jnp.bfloat16)), (1e-2, 1e-2))
    made = Dense.make(torch.Generator().manual_seed(0), 4, 3, dtype=BF,
                      device="cpu")
    assert made.W.dtype == BF and made.b.dtype == BF
    with pytest.raises(TypeError, match="compute_dtype"):
        Dense(torch.zeros(2, 2), torch.zeros(2), compute_dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 parameters"):
        Dense(torch.zeros(2, 2, dtype=torch.float16),
              torch.zeros(2, dtype=torch.float16))


def test_bridge_carries_bf16_leaves_bit_for_bit():
    """A JAX bfloat16 leaf reaches the port with its bits (viewed as
    16-bit words, no ml_dtypes), into a bfloat16 parameter and, widened
    exactly, into a float32 one."""
    jflow = nf.realnvp(jax.random.key(0), 4, (8, 8), nlayers=2,
                       dtype=jnp.bfloat16)
    jflow = _perturb(jflow)
    arrays = jax_arrays(jflow)
    assert any(a.dtype.name == "bfloat16" for a in arrays.values())
    tflow = nft.realnvp(torch.Generator(), 4, (8, 8), nlayers=2, dtype=BF,
                        device="cpu")
    load_jax_params(tflow, arrays)
    wide = nft.realnvp(torch.Generator(), 4, (8, 8), nlayers=2,
                       device="cpu")
    load_jax_params(wide, arrays)
    n_w = 0
    for (name, p), (_, q) in zip(tflow.named_parameters(),
                                 wide.named_parameters()):
        assert p.dtype == BF and q.dtype == torch.float32
        assert torch.equal(p.float(), q), name
        n_w += 1
    # one leaf by its bits
    path = ".bijector.bijectors[0].stacked['s_even'].layers[0].W"
    bits = np.ascontiguousarray(arrays[path]).view(np.uint16)
    want = torch.from_numpy(bits.astype(np.int32))
    got = tflow.bijector.bijectors[0].stacked["s_even"]
    layer = torch.stack([m.layers[0].W for m in got])
    assert torch.equal(layer.view(torch.int16).to(torch.int32) & 0xFFFF,
                       want)
    assert n_w > 0


# ---------------------------------------------------------------------------
# The policy's flows against JAX
# ---------------------------------------------------------------------------

def _policy_pair(kind, seed=0, d=4, hdims=(16, 16), nlayers=2):
    cd = dict(compute_dtype=jnp.bfloat16)
    tcd = dict(compute_dtype=BF)
    g = torch.Generator().manual_seed(seed)
    key = jax.random.key(seed)
    if kind == "realnvp":
        jflow = nf.realnvp(key, d, hdims, nlayers=nlayers, **cd)
        tflow = nft.realnvp(g, d, hdims, nlayers=nlayers, device="cpu", **tcd)
    elif kind == "realnvp_remat":
        jflow = nf.realnvp(key, d, hdims, nlayers=nlayers, remat=True, **cd)
        tflow = nft.realnvp(g, d, hdims, nlayers=nlayers, device="cpu",
                            remat=True, **tcd)
    elif kind == "fused":
        jflow = nf.realnvp(key, d, hdims, nlayers=nlayers, fused=True,
                           interpret=True, **cd)
        tflow = nft.realnvp(g, d, hdims, nlayers=nlayers, fused=True,
                            device="cpu", **tcd)
    elif kind == "glow":
        jflow = nf.glow(key, d, hdims, nlayers=nlayers, **cd)
        tflow = nft.glow(g, d, hdims, nlayers=nlayers, device="cpu", **tcd)
    elif kind == "nsf":
        jflow = nf.nsf(key, d, hdims, K=8, B=4.0, nlayers=nlayers,
                       backend="pallas", interpret=True, identity_init=True,
                       **cd)
        tflow = nft.nsf(g, d, hdims, K=8, B=4.0, nlayers=nlayers,
                        identity_init=True, device="cpu", **tcd)
    jflow = _perturb(jflow, seed + 1)
    load_jax_params(tflow, jax_arrays(jflow))
    return jflow, tflow


def _loss(y, ld, mod):
    return mod.sum(mod.sin(y)) + 0.5 * mod.sum(ld)


POLICY_KINDS = ["realnvp", "realnvp_remat", "fused", "glow", "nsf"]


@pytest.mark.parametrize("kind", POLICY_KINDS)
def test_policy_flow_matches_jax(kind):
    """Forward and inverse values and log-dets, and the gradient of every
    parameter through both directions, under the bf16 policy."""
    jflow, tflow = _policy_pair(kind)
    x = _draws(4, 64, scale=1.5)
    for inverse in (False, True):
        name = "inverse_and_log_det" if inverse else "forward_and_log_det"
        y_j, ld_j = jax.jit(getattr(jflow.bijector, name))(jnp.asarray(x))
        tflow.zero_grad()
        y_t, ld_t = getattr(tflow.bijector, name)(torch.from_numpy(x))
        assert y_t.dtype == torch.float32 and ld_t.dtype == torch.float32
        _close(y_t, y_j, POLICY_TOL["v"], f"{kind} {name} y")
        _close(ld_t, ld_j, POLICY_TOL["v"], f"{kind} {name} ld")
        _loss(y_t, ld_t, torch).backward()
        grads = jax.jit(jax.grad(lambda m: _loss(
            *getattr(m, name)(jnp.asarray(x)), jnp)))(jflow.bijector)
        ref = dict(load_jax_params(copy.deepcopy(tflow.bijector),
                                   jax_arrays(grads)).named_parameters())
        for pname, p in tflow.bijector.named_parameters():
            if p.grad is None:  # glow's identity ActNorm in one direction
                continue
            _close(p.grad, ref[pname], POLICY_TOL["g"], f"{kind} {pname}")


def _presampled(draws):
    draws = torch.from_numpy(draws)
    pos = [0]

    def gen(generator, flow, chunk):
        out = draws[pos[0]:pos[0] + chunk]
        pos[0] += chunk
        return out

    return gen


@pytest.mark.parametrize("kind", POLICY_KINDS)
def test_policy_elbo_and_adam_steps_match_jax(kind):
    """The ELBO and its gradients, then 5 Adam steps of `train_flow` on the
    same draws against JAX's jitted step: losses and final parameters,
    which stay float32."""
    jflow, tflow = _policy_pair(kind)
    target = nf.Banana(4, 1.0, 10.0)
    draws = _draws(4, 5 * 16, seed=3).reshape(5, 16, 4)
    optimizer = optax.adam(1e-3)
    mask = trainable_mask(jflow, frozen=lambda m: m is jflow.base)

    @jax.jit
    def step(f, st, xs):
        loss, grads = jax.value_and_grad(
            lambda f: -nf.elbo_from_samples(xs, f, target.log_prob))(f)
        grads = apply_mask(grads, mask)
        updates, st = optimizer.update(grads, st, f)
        return optax.apply_updates(f, updates), st, loss, grads

    st, losses = optimizer.init(jflow), []
    first_grads = None
    for xs in draws:
        jflow, st, loss, grads = step(jflow, st, jnp.asarray(xs))
        first_grads = grads if first_grads is None else first_grads
        losses.append(float(loss))
    # the first step's gradient, through the ELBO
    probe = copy.deepcopy(tflow)
    v = -nft.elbo_from_samples(torch.from_numpy(draws[0]), probe,
                               nft.Banana(4, 1.0, 10.0).log_prob)
    v.backward()
    ref = dict(load_jax_params(copy.deepcopy(tflow),
                               jax_arrays(first_grads)).named_parameters())
    for name, p in probe.bijector.named_parameters():
        if p.grad is not None:
            _close(p.grad, ref["bijector." + name], POLICY_TOL["g"], name)
    res = nft.train_flow(
        torch.Generator(), lambda xs, f, logp: nft.elbo_from_samples(
            xs, f, logp), tflow, nft.Banana(4, 1.0, 10.0).log_prob,
        max_iters=5, check_every=5, scan_inputs=_presampled(draws),
        optimizer=lambda p: torch.optim.Adam(p, lr=1e-3))
    np.testing.assert_allclose(res.stats["loss"], losses,
                               rtol=POLICY_TOL["v"][0],
                               atol=POLICY_TOL["v"][1])
    want = dict(load_jax_params(copy.deepcopy(tflow),
                                jax_arrays(jflow)).named_parameters())
    for name, p in res.flow.named_parameters():
        assert p.dtype == torch.float32
        _close(p, want[name], POLICY_TOL["v"], name)


# tests/test_dtype_policy.py's four properties, held on the port
def _policy_flows(kind="realnvp"):
    kw = dict(nlayers=3, device="cpu")
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    if kind == "nsf":
        kw.update(K=8, B=4.0, identity_init=True)
        make = nft.nsf
    else:
        kw.update(fused=kind == "fused")
        make = nft.realnvp
    f32 = make(g(), 8, (32, 32), **kw)
    bf16 = make(g(), 8, (32, 32), compute_dtype=BF, **kw)
    if kind == "nsf":
        for f in (f32, bf16):
            with torch.no_grad():
                for i, p in enumerate(f.parameters()):
                    p.add_(0.05 * torch.randn(
                        p.shape, generator=torch.Generator().manual_seed(i)))
    return f32, bf16


@pytest.mark.parametrize("kind", ["realnvp", "fused", "nsf"])
def test_policy_properties(kind):
    """Parameters stay float32; outputs are float32 and track the float32
    flow within JAX's 0.05; the round trip holds to 1e-4 (one bfloat16
    program both ways); the flow trains (finite gradients, Adam keeps the
    master dtype)."""
    f32, bf16 = _policy_flows(kind)
    assert {p.dtype for p in bf16.parameters()} == {torch.float32}
    x = torch.from_numpy(_draws(8, 64, seed=1))
    y32, ld32 = f32.bijector.forward_and_log_det(x)
    y16, ld16 = bf16.bijector.forward_and_log_det(x)
    assert y16.dtype == torch.float32 and ld16.dtype == torch.float32
    assert float(((y16 - y32).abs() / y32.abs().clamp_min(1.0)).max()) < 0.05
    assert float(((ld16 - ld32).abs() / ld32.abs().clamp_min(1.0)).max()) \
        < 0.05
    with torch.no_grad():
        x2, ld2 = bf16.bijector.inverse_and_log_det(y16)
    assert float((x - x2).abs().max()) < 1e-4 * max(float(x.abs().max()), 1)
    assert float((ld16 + ld2).abs().max()) < 1e-4
    target = nft.Banana(8, 1.0, 10.0)
    res = nft.train_flow(torch.Generator().manual_seed(3), nft.elbo_batch,
                         bf16, target.log_prob, 32, max_iters=3,
                         check_every=3,
                         optimizer=lambda p: torch.optim.Adam(p, lr=1e-3))
    assert np.isfinite(res.stats["loss"]).all()
    assert {p.dtype for p in res.flow.parameters()} == {torch.float32}
    grads = [p.grad for p in res.flow.bijector.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)


def test_nsf_policy_feeds_the_kernel_bf16_raw_and_remat_keeps_the_bits():
    """Under the policy the spline tile reads bfloat16 raw (and writes
    graw in bfloat16); `remat=True` gives the bits of ``remat=False`` in
    value and every gradient, and runs the spline forward once a coupling
    (its recompute takes the VJP, never K1)."""
    seen = []
    orig = rqs_cuda.tile_transform

    def spy(x, raw, B, inverse=False):
        seen.append((x.dtype, raw.dtype))
        return orig(x, raw, B, inverse)

    flows = [nft.nsf(torch.Generator().manual_seed(4), 4, (16, 16), K=8,
                     B=4.0, nlayers=2, identity_init=True, device="cpu",
                     compute_dtype=BF, remat=r) for r in (False, True)]
    with torch.no_grad():
        for f in flows:
            for i, p in enumerate(f.parameters()):
                p.add_(0.1 * torch.randn(
                    p.shape, generator=torch.Generator().manual_seed(i)))
    x = torch.from_numpy(_draws(4, 48, seed=6, scale=2.0))
    out = []
    rqs_cuda.tile_transform = spy
    try:
        for f in flows:
            seen.clear()
            v = nft.elbo_from_samples(x, f, nft.Banana(4, 1.0, 10.0).log_prob)
            v.backward()
            out.append((v.detach(), len(seen),
                        [p.grad for p in f.parameters()
                         if p.grad is not None]))
            assert set(seen) == {(torch.float32, BF)}
    finally:
        rqs_cuda.tile_transform = orig
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] == 4
    assert len(out[0][2]) == len(out[1][2]) > 0
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The kernels' bfloat16 plain versions
# ---------------------------------------------------------------------------

def _rqs_inputs(n, K, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-1.5, 1.5, n) * 4.0).astype(np.float32)
    raw = rng.standard_normal((n, 3 * K - 1)).astype(np.float32)
    gy = rng.standard_normal(n).astype(np.float32)
    gld = rng.standard_normal(n).astype(np.float32)
    return x, raw, gy, gld


@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("inverse", [False, True])
def test_rqs_bf16_raw_plain_matches_the_pallas_kernel(K, inverse):
    """K1–K3's plain versions on (float32 x, bfloat16 raw) against JAX
    `rqs_fused` in interpret mode on the same bfloat16 raw: both widen raw
    and compute in float32, so float32 tolerances hold (values 1e-5,
    gradients 2e-3/1e-4, tests/test_rqs_kernel.py). graw comes back in
    bfloat16 in both."""
    x, raw, gy, gld = _rqs_inputs(300, K, seed=K)
    raw_j = jnp.asarray(raw, jnp.bfloat16)
    raw_t = torch.from_numpy(raw).to(BF)

    @jax.jit
    def jax_side(x, raw, gy, gld):
        out, vjp = jax.vjp(lambda a, r: rqs_pallas.rqs_fused(
            a, r, 4.0, inverse=inverse, interpret=True), x, raw)
        return out, vjp((gy, gld))

    (y_j, ld_j), (gx_j, graw_j) = jax_side(
        jnp.asarray(x), raw_j, jnp.asarray(gy), jnp.asarray(gld))
    assert graw_j.dtype == jnp.bfloat16
    xt = torch.from_numpy(x).requires_grad_()
    rt = raw_t.clone().requires_grad_()
    y_t, ld_t = rqs_cuda.rqs_fused(xt, rt, 4.0, inverse=inverse)
    gx_t, graw_t = torch.autograd.grad((y_t, ld_t), (xt, rt),
                                       (torch.from_numpy(gy),
                                        torch.from_numpy(gld)))
    assert y_t.dtype == torch.float32 and graw_t.dtype == BF
    _close(y_t, y_j, (1e-5, 1e-5), "y")
    _close(ld_t, ld_j, (1e-4, 1e-5), "ld")
    _close(gx_t, gx_j, (2e-3, 1e-4), "gx")
    # graw is rounded to bfloat16 on both sides: one ulp apart where the
    # float32 values straddle a rounding
    _close(graw_t, graw_j, (2 ** -7, 1e-4), "graw")


@pytest.mark.parametrize("inverse", [False, True])
def test_rqs_bf16_x_plain_computes_in_f32_and_rounds_once(inverse):
    """(bfloat16 x, bfloat16 raw): the plain tiles widen x and raw,
    compute the float32 tiles' values and round each output once; the
    padded elem-major call gives the unpadded bits and exact bfloat16
    zeros in the pad columns; the JAX kernel (which computes in bfloat16)
    agrees to bfloat16 roundings."""
    K = 10
    x, raw, gy, gld = _rqs_inputs(257, K, seed=3)
    xb, rb = torch.from_numpy(x).to(BF), torch.from_numpy(raw).to(BF)
    gyb, gldb = torch.from_numpy(gy).to(BF), torch.from_numpy(gld).to(BF)
    y, ld = rqs_cuda.tile_transform(xb, rb, 4.0, inverse)
    y32, ld32 = rqs_cuda.tile_transform(xb.float(), rb, 4.0, inverse)
    assert y.dtype == BF and torch.equal(y, y32.to(BF))
    assert torch.equal(ld, ld32.to(BF))
    tile = (rqs_cuda.tile_bwd_analytic_inverse if inverse
            else rqs_cuda.tile_bwd_analytic)
    gx, graw = tile(xb, rb, gyb, gldb, 4.0)
    gx32, graw32 = tile(xb.float(), rb, gyb.float(), gldb.float(), 4.0)
    assert gx.dtype == BF and graw.dtype == BF
    assert torch.equal(gx, gx32.to(BF)) and torch.equal(graw, graw32)
    pad = torch.cat([rb, torch.full((257, 3), float("nan"), dtype=BF)], 1)
    xr = xb.clone().requires_grad_()
    pr = pad.clone().requires_grad_()
    yp, ldp = rqs_cuda.rqs_fused_e(xr, pr, 4.0, K, inverse=inverse)
    gxp, gpad = torch.autograd.grad((yp, ldp), (xr, pr), (gyb, gldb))
    assert torch.equal(yp, y) and torch.equal(ldp, ld)
    assert torch.equal(gxp, gx) and torch.equal(gpad[:, :3 * K - 1], graw)
    assert gpad.dtype == BF and not torch.count_nonzero(gpad[:, 3 * K - 1:])
    assert bool(torch.isfinite(gpad[:, 3 * K - 1:]).all())
    run = jax.jit(lambda a, r: rqs_pallas.rqs_fused(
        a, r, 4.0, inverse=inverse, interpret=True))
    xj, rj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(raw, jnp.bfloat16)
    out16 = run(xj, rj)
    out32 = run(xj.astype(jnp.float32), rj.astype(jnp.float32))
    # the float32 kernel on the same bfloat16 inputs, rounded once
    _close(y, out32[0], (ONE_ROUNDING, 1e-5), "y")
    _close(ld, out32[1], (ONE_ROUNDING, 1e-4), "ld")
    _no_worse(y, out16[0], out32[0], "y")
    _no_worse(ld, out16[1], out32[1], "ld")


def test_rqs_kernel_types_and_raw_dtype():
    """The (x, raw) pairs the kernels take, and where raw is cast to x's
    dtype instead."""
    f32, f64 = torch.float32, torch.float64
    assert set(rqs_cuda.KERNEL_TYPES) == {(f32, f32), (f64, f64), (f32, BF),
                                          (BF, BF)}
    assert rqs_cuda.raw_dtype_for(f32, BF) == BF
    assert rqs_cuda.raw_dtype_for(BF, BF) == BF
    assert rqs_cuda.raw_dtype_for(f64, BF) == f64
    assert rqs_cuda.raw_dtype_for(BF, f32) == BF
    assert rqs_cuda.fwd_plan(29, 10, 2) == rqs_cuda.FwdPlan(True, 29,
                                                            256 * 29 * 2)
    assert rqs_cuda.bwd_plan(29, 29, 10, 2).bytes == 256 * 29 * 2


def _fused_bf16_pair(cd, d=4, hdims=(16, 16), nlayers=2):
    """A perturbed JAX fused RealNVP and the port's (float32 under the
    policy ``cd``, or bfloat16 parameters)."""
    jdt = jnp.bfloat16 if cd is None else jnp.float32
    jflow = nf.realnvp(jax.random.key(0), d, hdims, nlayers=nlayers,
                       dtype=jdt, fused=True, interpret=True,
                       compute_dtype=None if cd is None else jnp.bfloat16)
    jflow = _perturb(jflow, 1)
    tflow = nft.realnvp(torch.Generator(), d, hdims, nlayers=nlayers,
                        dtype=BF if cd is None else torch.float32,
                        fused=True, compute_dtype=cd, device="cpu")
    load_jax_params(tflow, jax_arrays(jflow))
    return jflow.bijector.bijectors[0], tflow.bijector.bijectors[0]


@pytest.mark.parametrize("cd", [BF, None])
@pytest.mark.parametrize("inverse", [False, True])
def test_coupling_bf16_plain_matches_the_pallas_kernel(cd, inverse):
    """K4/K5's plain versions under the policy (``cd``) and with bfloat16
    parameters against JAX `coupling_stack_fused(interpret=True)`: y, ld,
    gx and every weight gradient; with bfloat16 parameters every output
    and gradient comes back in bfloat16. The policy is one program on both
    sides (POLICY_TOL); bfloat16 storage computes in float32 here and in
    bfloat16 in JAX (PARAM_TOL)."""
    jb, tb = _fused_bf16_pair(cd)
    n, d = 96, 4
    x = _draws(d, n, seed=4)
    rng = np.random.default_rng(5)
    gy = rng.standard_normal((n, d)).astype(np.float32) / n
    gld = rng.standard_normal(n).astype(np.float32) / n
    jdt = jnp.float32 if cd is not None else jnp.bfloat16

    @jax.jit
    def jax_side(x, groups, gy, gld):
        out, vjp = jax.vjp(lambda a, g: jax_cp.coupling_stack_fused(
            a, g, jb.idx_even, jb.idx_odd, inverse=inverse, interpret=True,
            compute_dtype=None if cd is None else jnp.bfloat16), x, groups)
        return out, vjp((gy, gld))

    (y_j, ld_j), (gx_j, gw_j) = jax_side(
        jnp.asarray(x, jdt), jb.groups, jnp.asarray(gy, jdt),
        jnp.asarray(gld, jdt))
    if cd is None:  # bfloat16 storage: JAX in float32 on the same values
        (y_r, ld_r), (gx_r, gw_r) = jax_side(
            jnp.asarray(x, jdt).astype(jnp.float32), _as_f32(jb.groups),
            jnp.asarray(gy, jdt).astype(jnp.float32),
            jnp.asarray(gld, jdt).astype(jnp.float32))
    tdt = torch.float32 if cd is not None else BF
    leaves = cc._leaves(tb.groups)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y_t, ld_t = cc.coupling_stack_fused(xt, tb.groups, tb.idx_even,
                                        tb.idx_odd, inverse=inverse,
                                        compute_dtype=cd)
    grads = torch.autograd.grad((y_t, ld_t), [xt] + leaves,
                                (torch.from_numpy(gy).to(tdt),
                                 torch.from_numpy(gld).to(tdt)))
    assert y_t.dtype == tdt and all(g.dtype == tdt for g in grads)
    if cd is not None:
        tol_g = (POLICY_TOL["g"][0], POLICY_TOL["g"][1] / n)
        _close(y_t, y_j, POLICY_TOL["v"], "y")
        _close(ld_t, ld_j, POLICY_TOL["v"], "ld")
        _close(grads[0], gx_j, tol_g, "gx")
        for i, (a, b) in enumerate(zip(grads[1:],
                                       jax.tree_util.tree_leaves(gw_j))):
            _close(a, b, POLICY_TOL["g"], f"leaf {i}")
        return
    # each output the float32 value rounded once: within 2^-8 of JAX's
    # float32 kernel (atol for values near 0: 1e-5, the gradients' scale
    # 1/n), and no worse than JAX's bfloat16 kernel
    _close(y_t, y_r, (ONE_ROUNDING, 1e-5), "y")
    _close(ld_t, ld_r, (ONE_ROUNDING, 1e-5), "ld")
    _close(grads[0], gx_r, (ONE_ROUNDING, 1e-5 / n), "gx")
    for i, (a, b, c) in enumerate(zip(
            grads[1:], jax.tree_util.tree_leaves(gw_r),
            jax.tree_util.tree_leaves(gw_j))):
        _close(a, b, (ONE_ROUNDING, 1e-5), f"leaf {i}")
        _no_worse(a, c, b, f"leaf {i}")
    _no_worse(y_t, y_j, y_r, "y")
    _no_worse(grads[0], gx_j, gx_r, "gx")


def test_coupling_bf16_storage_plain_rounds_once():
    """With bfloat16 parameters `tile_flow`/`tile_flow_bwd` compute the
    float32 plain versions' values on the widened inputs and round each
    output once; under the policy every product's operands are rounded
    (`_dot`), and the selections are not."""
    _, tb = _fused_bf16_pair(None)
    sels = cc._sels(tb.idx_even, tb.idx_odd, 4)
    x = torch.from_numpy(_draws(4, 40, seed=7)).to(BF)
    gy, gld = torch.ones_like(x), torch.ones(40, dtype=BF)
    y, ld = cc.tile_flow(x, tb.groups, sels)
    wide = cc._unflatten([t.float() for t in cc._leaves(tb.groups)], 3)
    y32, ld32 = cc.tile_flow(x.float(), wide, sels)
    assert torch.equal(y, y32.to(BF)) and torch.equal(ld, ld32.to(BF))
    gx, tree = cc.tile_flow_bwd(x, tb.groups, gy, gld, sels)
    gx32, tree32 = cc.tile_flow_bwd(x.float(), wide, gy.float(),
                                    gld.float(), sels)
    assert torch.equal(gx, gx32.to(BF))
    for a, b in zip(cc._leaves(tree), cc._leaves(tree32)):
        assert a.dtype == BF and torch.equal(a, b.to(BF))
    a = torch.tensor([[1.0 + 2 ** -10, 3.0]])
    b = torch.tensor([[1.0], [1.0]])
    assert float(cc._dot(a, b, BF)) == 4.0
    assert float(cc._dot(a, b)) == 4.0 + 2 ** -10


def test_kernel_suffixes_and_counts():
    """The C entries each dtype pair reaches, and the launch counts the
    bfloat16 instantiations keep apart."""
    assert cc.KERNEL_TYPES[(torch.float32, BF)] == "f32_cbf16"
    assert cc.KERNEL_TYPES[(BF, None)] == "bf16"
    assert cc.word_of(BF) == 4 and cc.word_of(torch.float64) == 8
    assert launches.name_of("rqs_fwd", "f32") == "rqs_fwd"
    assert launches.name_of("rqs_fwd", "f32_rbf16") == "rqs_fwd_f32_rbf16"
    assert set(launches.BF16_KERNELS) <= set(launches.KERNELS)
    assert len(launches.BF16_KERNELS) == 10
    from normalizingflows_torch.ops import _build

    for name in launches.BF16_KERNELS:
        assert name in _build.ENTRIES
    x = torch.zeros((4, 4))
    leaves = cc._leaves(_fused_bf16_pair(None)[1].groups)
    with pytest.raises(TypeError, match="compute_dtype"):
        cc._kernel_args(x, leaves, cc._sels((0, 2), (1, 3), 4), 3)


# ---------------------------------------------------------------------------
# bfloat16 parameters: every family JAX builds with them
# ---------------------------------------------------------------------------

FAMILIES = [("realnvp", False), ("realnvp", True), ("nsf", False),
            ("glow", False), ("maf", False), ("iaf", False)]


@pytest.mark.parametrize("family,fused", FAMILIES)
def test_bf16_parameters_match_jax(family, fused):
    """`FlowConfig(dtype="bfloat16")` from JAX's JSON builds the family in
    bfloat16 on both sides; with JAX's (perturbed) weights the port's
    log_prob is no further from JAX's float32 log_prob on the same
    bfloat16 weights and inputs than JAX's bfloat16 one (nsf and fused
    realnvp: JAX's interpret-mode kernels)."""
    kw = dict(family=family, dim=4, nlayers=2, hdims=(8, 8), K=8, B=4.0,
              dtype="bfloat16", fused=fused)
    jc = jcfg.FlowConfig(**kw)
    tc = tcfg.config_from_json(jcfg.config_to_json(jc), tcfg.FlowConfig)
    assert isinstance(tc, tcfg.FlowConfig) and tc.dtype == "bfloat16"
    jflow = jc.build(jax.random.key(0))
    if family == "nsf" or fused:
        jflow = _rebuild_interpret(jflow, family)
    jflow = _perturb(jflow, 3, 0.05)
    tflow = tc.build(torch.Generator().manual_seed(0), device="cpu")
    assert {p.dtype for p in tflow.parameters()} == {BF}
    load_jax_params(tflow, jax_arrays(jflow))
    x = _draws(4, 64, seed=8)
    xj = jnp.asarray(x, jnp.bfloat16)
    lp_j = jax.jit(lambda f, a: f.log_prob(a))(jflow, xj)
    lp_r = jax.jit(lambda f, a: f.log_prob(a))(_as_f32(jflow),
                                              xj.astype(jnp.float32))
    lp_t = tflow.log_prob(torch.from_numpy(x).to(BF))
    assert lp_t.dtype == BF and lp_j.dtype == jnp.bfloat16
    assert bool(torch.isfinite(lp_t.float()).all())
    _no_worse(lp_t, lp_j, lp_r, f"{family} log_prob")


def _rebuild_interpret(jflow, family):
    """JAX's config builds for the TPU; the same flow with its kernels in
    interpret mode (nsf: backend="pallas")."""
    def fix(obj):
        if hasattr(obj, "interpret"):
            obj = dataclasses.replace(obj, interpret=True)
        if family == "nsf" and hasattr(obj, "backend"):
            obj = dataclasses.replace(obj, backend="pallas")
        return obj

    chain = jflow.bijector
    return dataclasses.replace(jflow, bijector=dataclasses.replace(
        chain, bijectors=tuple(fix(b) for b in chain.bijectors)))


@pytest.mark.parametrize("family,fused", [("nsf", False), ("realnvp", True),
                                          ("maf", False)])
def test_bf16_parameters_train_and_checkpoint(family, fused, tmp_path):
    """`TrainConfig.run` trains a bfloat16 flow (finite losses, bfloat16
    parameters after Adam) and its checkpoint round-trips with identical
    bits; a policy flow's does too."""
    flow_cfg = tcfg.FlowConfig(family=family, dim=2, nlayers=2,
                               hdims=(8, 8), K=8, B=4.0, dtype="bfloat16",
                               fused=fused)
    objective = "mle" if family == "maf" else "elbo_batch"
    data = _draws(2, 256, seed=9) if objective == "mle" else None
    cfg = tcfg.TrainConfig(flow=flow_cfg, objective=objective, max_iters=4,
                           n_samples=16, batch_size=16, check_every=2,
                           seed=1)
    res = cfg.run(target_logp=nft.Banana(2, 1.0, 10.0).log_prob, data=data,
                  device="cpu")
    assert np.isfinite(res.stats["loss"]).all()
    assert {p.dtype for p in res.flow.parameters()} == {BF}
    path = str(tmp_path / "ck.pt")
    tck.save_pytree(path, res.flow)
    back = tck.load_pytree(path, flow_cfg.build(torch.Generator(),
                                                device="cpu"))
    for (n, a), (_, b) in zip(res.flow.state_dict().items(),
                              back.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    policy = nft.realnvp(torch.Generator().manual_seed(2), 2, (8, 8),
                         nlayers=2, compute_dtype=BF, device="cpu")
    tck.save_pytree(path, policy)
    again = tck.load_pytree(path, nft.realnvp(
        torch.Generator(), 2, (8, 8), nlayers=2, compute_dtype=BF,
        device="cpu"))
    assert again.bijector.bijectors[0].stacked["s_even"][0].layers[
        0].compute_dtype == BF
    for a, b in zip(policy.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_train_realnvp_fused_policy_and_bf16():
    """K6's trainer takes a policy flow and trains it in float32 (JAX's K6
    has no compute dtype), the policy kept; bfloat16 weights raise,
    naming the roadmap item that takes K6 in bfloat16."""
    flow = nft.realnvp(torch.Generator().manual_seed(0), 2, (8, 8),
                       nlayers=2, fused=True, compute_dtype=BF, device="cpu")
    res = nft.train_realnvp_fused(torch.Generator().manual_seed(1), flow,
                                  nft.Banana(2, 1.0, 10.0), 8, max_iters=3)
    assert np.isfinite(res.stats["loss"]).all()
    assert res.flow.bijector.bijectors[0].compute_dtype == BF
    bf = nft.realnvp(torch.Generator(), 2, (8, 8), nlayers=2, fused=True,
                     dtype=BF, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        nft.train_realnvp_fused(torch.Generator(), bf,
                                nft.Banana(2, 1.0, 10.0), 8, max_iters=2)


def test_config_json_round_trip_of_bf16():
    """JAX's JSON of a bfloat16 config is the port's."""
    jc = jcfg.FlowConfig(family="nsf", dtype="bfloat16")
    tc = tcfg.config_from_json(jcfg.config_to_json(jc), tcfg.FlowConfig)
    assert tc.dtype == "bfloat16"
    assert json.loads(tcfg.config_to_json(tc)) == json.loads(
        jcfg.config_to_json(jc))


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(64, 16), (4, 8, 16)])
def test_chip_smoke_witness_product_is_the_policy(shape):
    """chip_smoke's `_WitnessMatmul` (the policy written apart, float64
    sums), which phases 48-49 hold the card's first step against, gives
    `_MixedMatmul`'s value and both gradients on the CPU within 1e-6
    relative (measured at most 2e-7: float32 against float64 sums of the
    same bfloat16 operands)."""
    from normalizingflows_torch.models import nets

    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((16, 24)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape[:-1] + (24,)).astype(
        np.float32))
    outs = []
    for fn in (nets._MixedMatmul, cs._WitnessMatmul):
        xg, Wg = x.clone().requires_grad_(), W.clone().requires_grad_()
        y = fn.apply(xg, Wg, BF)
        outs.append([y, *torch.autograd.grad(y, (xg, Wg), g)])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        assert cs._rel([a], [b]) < 1e-6


def test_chip_smoke_policy_bound_counts_macs_at_the_bf16_peak():
    """Under the policy K4/K5's bound counts the MACs at the bfloat16
    tensor-core peak and the rest at float32's, taking the larger time
    against the bytes; float32 and bfloat16 storage count all at
    float32's. The operation count is the parent's."""
    cs = _chip_smoke()
    for kernel in ("coupling_fwd", "coupling_bwd"):
        for model, n in (("demo", 16), ("ref", 256), ("demo", 262144)):
            cfg = cs.CPL_CFG[model]
            macs, other = cs._coupling_ops(kernel, cfg)
            ops, nbytes = cs.coupling_work(kernel, cfg, n, 4)
            assert ops == n * (macs + other)
            f32, by32 = cs.coupling_bound_ms(kernel, cfg, n)
            assert f32 == pytest.approx(1e3 * max(
                nbytes / cs.PEAK_BYTES_PER_S, ops / cs.PEAK_F32_PER_S))
            pol, by = cs.coupling_bound_ms(kernel, cfg, n, 4, policy=True)
            assert pol == pytest.approx(1e3 * max(
                nbytes / cs.PEAK_BYTES_PER_S,
                n * macs / cs.PEAK_BF16_PER_S,
                n * other / cs.PEAK_F32_PER_S))
            assert pol <= f32
    # K5 at the demo's 262,144 rows: operations both ways, the policy's
    # bound set by the non-MAC work at the float32 rate
    cfg = cs.CPL_CFG["demo"]
    assert cs.coupling_bound_ms("coupling_bwd", cfg, 262144) == (
        pytest.approx(0.08756392), "operations")
    assert cs.coupling_bound_ms("coupling_bwd", cfg, 262144, 4, True) == (
        pytest.approx(0.00643231), "operations")


def test_chip_smoke_top_level_names_are_defined_once():
    """No function or class of chip_smoke.py is defined twice: a later
    definition would replace the earlier one for every phase."""
    import ast
    from collections import Counter
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parents[1]
                      / "chip_smoke.py").read_text())
    names = Counter(node.name for node in tree.body
                    if isinstance(node, (ast.FunctionDef, ast.ClassDef)))
    assert [n for n, c in names.items() if c > 1] == []
