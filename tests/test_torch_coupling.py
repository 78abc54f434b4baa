"""The port's RealNVP against the JAX package's.

A JAX `realnvp(...)` (or `AffineCoupling`) is built from a key, moved off
its zero biases by noise of 0.1 on every parameter, and carried over with
`load_jax_params`; both sides get the same inputs, made with numpy from a
seed. Compared: the unfused module path (`AffineCoupling`,
`CouplingPairStack`, and a hand-built `Chain` of `RealNVP_layer` blocks)
against JAX `realnvp(fused=False)` (``scan=True`` and ``scan=False``);
the fused stack's plain versions (`tile_flow`, `tile_flow_bwd`, what
`coupling_stack_fused` runs on CPU tensors) against JAX
`coupling_stack_fused(interpret=True)`, which runs the Pallas kernels
#6/#7 in interpret mode; the hand-written reverse sweep against autograd;
the fused and unfused flows from one seed; ``remat``; K5's shared-memory
cap; and 5 Adam steps of `train_flow` on both paths against JAX
`train_flow`'s step.

Tolerances: f64 rtol 1e-9 (atol 1e-9 for values near 0) between the
packages (same operations, libraries' matmul and exp orders differ). f32
those of the JAX suite's fused-kernel tests (tests/test_coupling_kernel.py
:35-36, 65, 80): values rtol/atol 1e-5, log-dets rtol 1e-4 atol 1e-5,
gradients rtol 2e-3 atol 1e-4. Training: f64 rtol 1e-8, f32 rtol 1e-4 atol
1e-5 (tests/test_torch_train.py).
"""

import copy
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.experimental import (  # noqa: E402
    coupling_pallas as jax_cp,
)
from normalizingflows.jl_tpu.utils.pytree import (  # noqa: E402
    apply_mask,
    trainable_mask,
)
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.experimental import coupling_cuda as cc  # noqa
from normalizingflows_torch.experimental import FusedRealNVP  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": dict(y=(1e-5, 1e-5), ld=(1e-4, 1e-5), g=(2e-3, 1e-4)),
       "f64": dict(y=(1e-9, 1e-9), ld=(1e-9, 1e-9), g=(1e-9, 1e-9))}
TRAIN_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-8, 1e-12)}


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _close(a, b, tol, msg=""):
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol[0], atol=tol[1],
                               err_msg=msg)


def _perturb(tree, seed=2, sigma=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + sigma * jnp.asarray(rng.standard_normal(a.shape),
                                          a.dtype), tree)


def _draws(dt, d, n, seed=1):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        DT[dt][2])


def _pair(dt, d, hdims, nlayers, fused=False, scan=True, seed=0):
    """A perturbed JAX realnvp and the port's copy of it. ``scan=False``:
    the JAX flat layout against a `Chain` of `RealNVP_layer` blocks."""
    jdt, tdt, _ = DT[dt]
    jflow = _perturb(nf.realnvp(jax.random.key(seed), d, hdims,
                                nlayers=nlayers, dtype=jdt, scan=scan,
                                fused=fused, interpret=True), seed + 1)
    g = torch.Generator().manual_seed(seed)
    if scan:
        tflow = nft.realnvp(g, d, hdims, nlayers=nlayers, dtype=tdt,
                            fused=fused, device="cpu")
    else:
        tflow = nft.create_flow(
            [nft.Chain(nft.RealNVP_layer(g, d, hdims, tdt, "cpu"))
             for _ in range(nlayers)],
            nft.DiagNormal.standard(d, tdt, "cpu"))
    load_jax_params(tflow, jax_arrays(jflow))
    return jflow, tflow


def _grad_loss(y, ld, np_mod):
    return np_mod.sum(np_mod.sin(y)) + 0.5 * np_mod.sum(ld)


# (a) the unfused module path, layout by layout
@pytest.mark.parametrize("dt,layout,d,hdims", [
    ("f32", "scan", 4, (16, 16)), ("f64", "scan", 5, (8, 8)),
    ("f32", "chain", 2, (8, 8)), ("f64", "chain", 4, (16, 16)),
    ("f32", "coupling", 4, (16, 16)), ("f64", "coupling", 5, (8, 8))])
def test_unfused_matches_jax(dt, layout, d, hdims):
    """Forward and inverse values and log-dets, and the gradient of every
    conditioner W and b through both directions, against JAX."""
    jdt, tdt, _ = DT[dt]
    if layout == "coupling":
        jmod = _perturb(nf.AffineCoupling.make(
            jax.random.key(3), d, hdims, range(1, d, 2), jdt))
        tmod = nft.AffineCoupling.make(torch.Generator().manual_seed(3), d,
                                       hdims, range(1, d, 2), tdt, "cpu")
        load_jax_params(tmod, jax_arrays(jmod))
    else:
        jflow, tflow = _pair(dt, d, hdims, 3, scan=layout == "scan")
        jmod, tmod = jflow.bijector, tflow.bijector
    x = _draws(dt, d, 300)
    tol = TOL[dt]
    for inverse in (False, True):
        name = "inverse_and_log_det" if inverse else "forward_and_log_det"
        y_j, ld_j = jax.jit(getattr(jmod, name))(jnp.asarray(x))
        tmod.zero_grad()
        y_t, ld_t = getattr(tmod, name)(torch.from_numpy(x))
        _close(y_t, y_j, tol["y"], name)
        _close(ld_t, ld_j, tol["ld"], name)
        _grad_loss(y_t, ld_t, torch).backward()
        grads = jax.jit(jax.grad(lambda m: _grad_loss(
            *getattr(m, name)(jnp.asarray(x)), jnp)))(jmod)
        ref = dict(load_jax_params(copy.deepcopy(tmod),
                                   jax_arrays(grads)).named_parameters())
        assert len(ref) > 0
        for pname, p in tmod.named_parameters():
            _close(p.grad, ref[pname].detach().numpy(), tol["g"], pname)


def _fused_groups(dt, d, hdims, nlayers, seed=0):
    """A perturbed JAX FusedRealNVP and the port's, with the same weights."""
    jflow, tflow = _pair(dt, d, hdims, nlayers, fused=True, seed=seed)
    return jflow.bijector.bijectors[0], tflow.bijector.bijectors[0]


# (b) the plain versions against the Pallas kernels (interpret mode)
@pytest.mark.parametrize("dt,d,hdims,n,inverse", [
    ("f32", 4, (16, 16), 300, False), ("f32", 4, (16, 16), 300, True),
    ("f64", 5, (8, 8), 300, False), ("f64", 5, (8, 8), 64, True),
    ("f64", 2, (16, 16), 64, False)])
def test_fused_stack_matches_jax_kernel(dt, d, hdims, n, inverse):
    """`coupling_stack_fused` on CPU tensors (`tile_flow`, `tile_flow_bwd`)
    against JAX `coupling_stack_fused(interpret=True)`: values and the VJP
    with respect to x and every stacked weight; odd d gives the two
    couplings different widths."""
    jb, tb = _fused_groups(dt, d, hdims, 2)
    rng = np.random.default_rng(5)
    x = _draws(dt, d, n, seed=4)
    gy = rng.standard_normal((n, d)).astype(DT[dt][2])
    gld = rng.standard_normal(n).astype(DT[dt][2])

    @jax.jit
    def jax_side(x, groups, gy, gld):
        out, vjp = jax.vjp(lambda a, g: jax_cp.coupling_stack_fused(
            a, g, jb.idx_even, jb.idx_odd, inverse=inverse, interpret=True),
            x, groups)
        return out, vjp((gy, gld))

    (y_j, ld_j), (gx_j, gw_j) = jax_side(jnp.asarray(x), jb.groups,
                                         jnp.asarray(gy), jnp.asarray(gld))
    leaves = cc._leaves(tb.groups)
    xt = torch.from_numpy(x).requires_grad_()
    y_t, ld_t = cc.coupling_stack_fused(xt, tb.groups, tb.idx_even,
                                        tb.idx_odd, inverse=inverse)
    grads = torch.autograd.grad((y_t, ld_t), [xt] + leaves,
                                (torch.from_numpy(gy), torch.from_numpy(gld)))
    tol = TOL[dt]
    _close(y_t, y_j, tol["y"], "y")
    _close(ld_t, ld_j, tol["ld"], "ld")
    _close(grads[0], gx_j, tol["g"], "gx")
    jleaves = jax.tree_util.tree_leaves(gw_j)
    assert len(jleaves) == len(leaves) == 4 * 2 * (len(hdims) + 1)
    for i, (a, b) in enumerate(zip(grads[1:], jleaves)):
        _close(a, b, tol["g"], f"leaf {i}")


# (c) the hand-written reverse sweep against the tape
@pytest.mark.parametrize("dt,d,inverse", [
    ("f64", 5, False), ("f64", 5, True), ("f32", 2, False),
    ("f32", 4, True)])
def test_tile_flow_bwd_matches_autograd(dt, d, inverse):
    _, tb = _fused_groups(dt, d, (8, 8), 3, seed=6)
    sels = cc._sels(tb.idx_even, tb.idx_odd, d)
    leaves = cc._leaves(tb.groups)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_draws(dt, d, 64, seed=8))
    gy = torch.from_numpy(rng.standard_normal((64, d)).astype(DT[dt][2]))
    gld = torch.from_numpy(rng.standard_normal(64).astype(DT[dt][2]))
    xg = x.clone().requires_grad_()
    y, ld = cc.tile_flow(xg, tb.groups, sels, inverse)
    tape = torch.autograd.grad((y, ld), [xg] + leaves, (gy, gld))
    gx, tree = cc.tile_flow_bwd(x, tb.groups, gy, gld, sels, inverse)
    tol = (1e-10, 1e-12) if dt == "f64" else TOL["f32"]["g"]
    for i, (a, b) in enumerate(zip([gx] + cc._leaves(tree), tape)):
        _close(a, b.numpy(), tol, f"output {i}")


# (d) one seed, two paths
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_fused_and_unfused_share_weights_and_elbo(dt):
    tdt = DT[dt][1]
    kw = dict(nlayers=3, dtype=tdt, device="cpu")
    fused = nft.realnvp(torch.Generator().manual_seed(9), 4, (16, 16),
                        fused=True, **kw)
    plain = nft.realnvp(torch.Generator().manual_seed(9), 4, (16, 16), **kw)
    fb, stack = fused.bijector.bijectors[0], plain.bijector.bijectors[0]
    assert isinstance(fb, FusedRealNVP)
    for grp in ("even", "odd"):
        for net in ("s", "t"):
            for li, (W, b) in enumerate(fb.groups[grp][net]):
                for i, mlp in enumerate(stack.stacked[f"{net}_{grp}"]):
                    assert torch.equal(W[i], mlp.layers[li].W)
                    assert torch.equal(b[i], mlp.layers[li].b)

    xs = torch.from_numpy(_draws(dt, 4, 64, seed=10))
    target = nft.Banana(4, 1.0, 100.0)
    vals = [nft.elbo_from_samples(xs, f, target.log_prob)
            for f in (fused, plain)]
    for v in vals:
        v.backward()
    _close(vals[0], vals[1].detach().numpy(), TOL[dt]["ld"])
    for grp in ("even", "odd"):
        for net in ("s", "t"):
            for li, (W, b) in enumerate(fb.groups[grp][net]):
                want = [torch.stack([m.layers[li].__getattr__(k).grad
                                     for m in stack.stacked[f"{net}_{grp}"]])
                        for k in ("W", "b")]
                _close(W.grad, want[0].numpy(), TOL[dt]["g"])
                _close(b.grad, want[1].numpy(), TOL[dt]["g"])


# (e) remat
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_remat_gives_the_same_loss_and_gradients(dt):
    tdt = DT[dt][1]
    flows = [nft.realnvp(torch.Generator().manual_seed(11), 5, (8, 8),
                         nlayers=3, dtype=tdt, device="cpu", remat=r)
             for r in (False, True)]
    assert flows[1].bijector.bijectors[0].remat
    xs = torch.from_numpy(_draws(dt, 5, 64, seed=12))
    target = nft.Banana(5, 1.0, 10.0)
    out = []
    for f in flows:
        v = nft.elbo_from_samples(xs, f, target.log_prob)
        v.backward()
        y, ld = f.bijector.inverse_and_log_det(xs)
        out.append((v.detach(), y.detach(), ld.detach(),
                    [p.grad for p in f.parameters() if p.grad is not None]))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])
    assert len(out[0][3]) == len(out[1][3]) == 4 * 3 * 3 * 2 + 2  # + base
    for a, b in zip(out[0][3], out[1][3]):
        assert torch.equal(a, b)


def _jax_train(jflow, target, draws, lr):
    """bench.py's `make_train_chunk` step, one jitted step per draw."""
    optimizer = optax.adam(lr)
    mask = trainable_mask(jflow, frozen=lambda m: m is jflow.base)

    @jax.jit
    def step(f, st, xs):
        loss, grads = jax.value_and_grad(
            lambda f: -nf.elbo_from_samples(xs, f, target.log_prob))(f)
        grads = apply_mask(grads, mask)
        updates, st = optimizer.update(grads, st, f)
        return optax.apply_updates(f, updates), st, loss

    st, losses = optimizer.init(jflow), []
    for xs in draws:
        jflow, st, loss = step(jflow, st, jnp.asarray(xs))
        losses.append(float(loss))
    return jflow, np.asarray(losses)


def _presampled(draws):
    draws = torch.from_numpy(draws)
    pos = [0]

    def gen(generator, flow, chunk):
        out = draws[pos[0]:pos[0] + chunk]
        pos[0] += chunk
        return out

    return gen


# (f) the slice's main path at a small size: 5 Adam steps on given draws
@pytest.mark.parametrize("dt,fused", [("f64", False), ("f64", True),
                                      ("f32", True)])
def test_train_flow_matches_jax(dt, fused):
    """The demo model (d=2, [16,16]x3) on Banana(2, 1, 100), 16 draws a
    step, Adam(5e-4): losses and final parameters."""
    jflow, tflow = _pair(dt, 2, (16, 16), 3, fused=fused)
    draws = np.random.default_rng(13).standard_normal((5, 16, 2)).astype(
        DT[dt][2])
    jflow, losses_j = _jax_train(jflow, nf.Banana(2, 1.0, 100.0), draws,
                                 5e-4)
    res = nft.train_flow(
        torch.Generator(), lambda xs, f, logp: nft.elbo_from_samples(
            xs, f, logp), tflow, nft.Banana(2, 1.0, 100.0).log_prob,
        max_iters=5, check_every=2, scan_inputs=_presampled(draws),
        optimizer=lambda p: torch.optim.Adam(p, lr=5e-4))
    rtol, atol = TRAIN_TOL[dt]
    np.testing.assert_allclose(res.stats["loss"], losses_j, rtol=rtol,
                               atol=atol)
    ref = dict(load_jax_params(copy.deepcopy(tflow),
                               jax_arrays(jflow)).named_parameters())
    for name, p in res.flow.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


# (g) the card by default
@pytest.mark.parametrize("fused", [False, True])
def test_realnvp_builds_on_the_card_unless_asked(fused):
    g = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        flow = nft.realnvp(g, 2, fused=fused)
        assert next(flow.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            nft.realnvp(g, 2, fused=fused)
    flow = nft.realnvp(g, 2, fused=fused, device="cpu")
    assert {p.device.type for p in flow.parameters()} == {"cpu"}


# (h) no fallback
def test_backend_cuda_on_cpu_tensors_raises():
    _, tb = _fused_groups("f64", 4, (8, 8), 2)
    x = torch.zeros((8, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        cc.coupling_stack_fused(x, tb.groups, tb.idx_even, tb.idx_odd,
                                backend="cuda")
    tb.backend = "cuda"
    with pytest.raises(ValueError, match="CUDA"):
        tb.forward_and_log_det(x)
    with pytest.raises(ValueError, match="backend"):
        cc.coupling_stack_fused(x, tb.groups, tb.idx_even, tb.idx_odd,
                                backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        FusedRealNVP(tb.groups, tb.idx_even, tb.idx_odd, backend="pallas")


def test_kernel_arguments_outside_the_bounds_raise():
    """Shapes the kernels are not instantiated for raise before any launch
    (d > 8, a layer wider than 32, more than 4 or fewer than 2 layers), as
    do unequal
    conditioner depths; CPU tensors are refused by the kernel path."""
    def groups_of(d, hdims, nlayers):
        flow = nft.realnvp(torch.Generator().manual_seed(0), d, hdims,
                           nlayers=nlayers, fused=True, device="cpu")
        fb = flow.bijector.bijectors[0]
        return fb, cc._sels(fb.idx_even, fb.idx_odd, d)

    for d, hdims in ((10, (8, 8)), (4, (64, 8)), (4, (8, 8, 8, 8)), (4, ())):
        fb, sels = groups_of(d, hdims, 1)
        with pytest.raises(ValueError, match="instantiated bounds"):
            cc._kernel_args(torch.zeros((4, d)), cc._leaves(fb.groups), sels,
                            len(hdims) + 1)
    fb, sels = groups_of(4, (8, 8), 2)
    with pytest.raises(ValueError, match="CUDA device"):
        cc._kernel_args(torch.zeros((4, 4)), cc._leaves(fb.groups), sels, 3)
    uneven = {"even": fb.groups["even"],
              "odd": {"s": list(fb.groups["odd"]["s"])[:2],
                      "t": fb.groups["odd"]["t"]}}
    with pytest.raises(ValueError, match="same depth"):
        cc.coupling_stack_fused(torch.zeros((4, 4)), uneven, fb.idx_even,
                                fb.idx_odd)


@pytest.mark.parametrize("dt,nlayers,cap", [("f64", 92, 91), ("f64", 91, None),
                                            ("f32", 92, None)])
def test_backward_shared_memory_cap(dt, nlayers, cap):
    """K5 keeps every coupling's input tile in shared memory: at d=8 with
    [32,32] conditioners and 2,048 rows (16-row lane tiles) float64 takes
    at most 91 blocks. Past the cap the
    backward's check raises (and with it a forward that will be
    differentiated); a forward alone, or a stack within the cap, goes on to
    the device check."""
    tdt = DT[dt][1]
    flow = nft.realnvp(torch.Generator().manual_seed(0), 8, (32, 32),
                       nlayers=nlayers, dtype=tdt, fused=True, device="cpu")
    fb = flow.bijector.bijectors[0]
    sels = cc._sels(fb.idx_even, fb.idx_odd, 8)
    x, leaves = torch.zeros((2048, 8), dtype=tdt), cc._leaves(fb.groups)
    with pytest.raises(ValueError, match="CUDA device"):
        cc._kernel_args(x, leaves, sels, 3)
    if cap is None:
        with pytest.raises(ValueError, match="CUDA device"):
            cc._kernel_args(x, leaves, sels, 3, backward=True)
    else:
        with pytest.raises(ValueError, match=f"at most {cap} blocks"):
            cc._kernel_args(x, leaves, sels, 3, backward=True)


# (i) the bf16 compute_dtype policy, which raised before it was ported
# (tests/test_torch_bf16.py holds it in full)
@pytest.mark.parametrize("fused", [False, True])
def test_compute_dtype_policy_builds_and_matches_jax(fused):
    """``compute_dtype=torch.bfloat16`` builds, unfused and fused, keeps
    float32 parameters and gives JAX's forward (JAX's fused kernel in
    interpret mode) within the policy's 1e-4."""
    jflow = _perturb(nf.realnvp(jax.random.key(0), 2, (16, 16), nlayers=3,
                                fused=fused, interpret=True,
                                compute_dtype=jnp.bfloat16), 1)
    tflow = nft.realnvp(torch.Generator().manual_seed(0), 2, (16, 16),
                        nlayers=3, fused=fused, compute_dtype=torch.bfloat16,
                        device="cpu")
    load_jax_params(tflow, jax_arrays(jflow))
    assert {p.dtype for p in tflow.parameters()} == {torch.float32}
    x = _draws("f32", 2, 64)
    y_j, ld_j = jax.jit(jflow.bijector.forward_and_log_det)(jnp.asarray(x))
    y_t, ld_t = tflow.bijector.forward_and_log_det(torch.from_numpy(x))
    _close(y_t, y_j, (1e-4, 1e-4))
    _close(ld_t, ld_j, (1e-4, 1e-4))


def test_round_trip_and_sampling_within_the_port():
    """log_prob(y) through the inverse equals sample_and_log_prob's value,
    on the fused and the unfused flow (f64)."""
    for fused in (False, True):
        _, tflow = _pair("f64", 4, (16, 16), 3, fused=fused)
        g = torch.Generator().manual_seed(14)
        with torch.no_grad():
            y, lq = tflow.sample_and_log_prob(g, (64,))
            _close(tflow.log_prob(y), lq.numpy(), (1e-10, 1e-10))


# (j) the host-side sizing of K5/K6's row tile (the only part of the tile
# that runs here)
ROOT = Path(__file__).resolve().parents[1]
F32, F64 = 4, 8


# (word, d, blocks, depth, hidden, n rows, K6?, tile rows, bytes). The lane
# tile (K5 while n is at most 128 tiles of R rows; K6 always): padded net, W's rows one
# word apart more than K4's, kHalf·(H+1) + H + (depth−2)·(H·(H+1) + H) +
# H·(kHalf+1) + kHalf words; saved inputs 2·blocks·rows·d; activations of
# two nets 2·rows·(kHalf + (depth−1)·H + kHalf); cotangents rows·H; K6
# no more (its ELBO terms are in device memory). The row tile (64 rows): net kHalf·H + H + (depth−2)·(H·H + H)
# + H·kHalf + kHalf; saved 2·blocks·64·d; activations 2·65·(kHalf +
# (depth−1)·H + kHalf); cotangents 65·H.
@pytest.mark.parametrize("word,d,blocks,depth,hidden,n,k6,rows,nbytes", [
    # demo, N 16 (16 rows, H=16): net 68+16+288+80+4 = 456;
    # 912 + 192 + 1280 + 256 = 2640 words
    (F32, 2, 3, 3, 16, 16, False, 16, 4 * 2640),
    # through K6 at batch 16: the same
    (F32, 2, 3, 3, 16, 16, True, 16, 4 * 2640),
    # demo, N 300: 300/128 rows, at least 8 warps: 16 rows
    (F32, 2, 3, 3, 16, 300, False, 16, 4 * 2640),
    # demo, N 4,096: 32 rows; 912 + 384 + 2560 + 512 = 4368
    (F32, 2, 3, 3, 16, 4096, False, 32, 4 * 4368),
    # demo, N 262,144 (4,096 lane tiles: the row tile): net 80+272+68 = 420;
    # 840 + 768 + 5200 + 1040 = 7848
    (F32, 2, 3, 3, 16, 262144, False, 64, 4 * 7848),
    # reference default, N 256 (8 warps of 1 row, H=32): net
    # 132+32+1088+160+4 = 1416; 2832 + 320 + 1152 + 256 = 4560
    (F32, 2, 10, 3, 32, 256, False, 8, 4 * 4560),
    # through K6 at batch 256 (32 rows): 2832 + 1280 + 4608 + 1024 = 9744
    (F32, 2, 10, 3, 32, 256, True, 32, 4 * 9744),
    # d=8 [32,32] float64, 14 blocks, N 2,048 (16-row tiles): 2832 + 3584 +
    # 2304 + 512 = 9232
    (F64, 8, 14, 3, 32, 2048, False, 16, 8 * 9232),
    # d=5 [8,8]x2 float32 through K6 at batch 100 (H=16, 64 rows): 912 +
    # 1280 + 5120 + 1024 = 8336
    (F32, 5, 2, 3, 8, 100, True, 64, 4 * 8336),
])
def test_row_tile_sizes_match_hand_counts(word, d, blocks, depth, hidden, n,
                                          k6, rows, nbytes):
    assert cc._bwd_tile(d, blocks, depth, hidden, word, n, k6) == (rows,
                                                                   nbytes)


def _parent_smem_bytes(d, n_blocks, depth, H, word, extra_words):
    """K5's shared memory before the lane tile: 64 rows a tile, caches
    unit-major with a row stride of 65, W's rows unpadded."""
    half, stride = 4, 65
    net = half * H + H + (depth - 2) * (H * H + H) + H * half + half
    acts = stride * (half + (depth - 1) * H) + stride * half
    return word * (2 * net + 2 * n_blocks * 64 * d + 2 * acts + stride * H
                   + extra_words)


@pytest.mark.parametrize("word,H", [(F32, 16), (F32, 32), (F64, 16),
                                    (F64, 32)])
def test_every_stack_accepted_before_is_still_accepted(word, H):
    """At every d and depth, the most blocks the 64-row tile took (K5, and
    K6 with its 64 words of terms) still fit, at any batch."""
    cap = cc.KERNEL_MAX_SMEM
    for d in range(2, 9):
        for depth in range(2, 5):
            for k6 in (False, True):
                n_max = 1
                while _parent_smem_bytes(d, n_max + 1, depth, H, word,
                                         64 * k6) <= cap:
                    n_max += 1
                for n in (1, 16, 17, 100, 300, 8192, 10**4, 10**6):
                    _, need = cc._bwd_tile(d, n_max, depth, H, word, n, k6)
                    assert need <= cap, (d, depth, k6, n, n_max)


def test_rows_match_the_device_header():
    """The lane tile's rows that csrc/coupling_device.cuh declares for each
    (type, H), and its switch to the row tile, are coupling_cuda's; each
    lane tile is whole warps of at most 1,024 threads."""
    import re

    text = (ROOT / "normalizingflows_torch" / "csrc"
            / "coupling_device.cuh").read_text()
    declared = {(F32 if t == "F32" else F64, int(h)): int(r)
                for t, h, r in re.findall(
                    r"constexpr int kBwdRows(F32|F64)H(16|32) = (\d+);",
                    text)}
    assert declared == cc.BWD_ROWS
    for (_, H), rows in declared.items():
        assert rows * H <= 1024 and rows * H % 32 == 0
    for name, value in (("kLaneMaxTiles", cc.LANE_MAX_TILES),
                        ("kRowTileRows", cc.ROW_TILE_ROWS),
                        ("kFwdRows", cc.FWD_ROWS),
                        ("kFwdLaneMaxTiles", cc.FWD_LANE_MAX_TILES)):
        assert f"constexpr int {name} = {value};" in text
    assert ("constexpr int kFwdResidentBytes = 48 * 1024;" in text
            and cc.FWD_RESIDENT_BYTES == 48 * 1024)
    assert cc.FWD_ROWS % 32 == 0


# (word, blocks, hidden, n rows, lane tile?, tile rows, resident?, bytes)
# of K4 at depth 3. A coupling is two nets. The lane tile's net (W's rows
# one word apart more) is kHalf·(H+1) + H + H·(H+1) + H + H·(kHalf+1) +
# kHalf words: 84 + 288 + 84 = 456 at H=16, 164 + 1088 + 164 = 1416 at
# H=32; the row tile's kHalf·H + H + H·H + H + H·kHalf + kHalf: 80 + 272 +
# 68 = 420 and 160 + 1056 + 132 = 1348. Every coupling (2·blocks of them)
# is held where they fit in 48 KB, else two. The lane tile runs while n is
# at most 64 tiles of R rows (R 64 / 32 / 32 / 16 for f32 H16 / f32 H32 /
# f64 H16 / f64 H32), with K5's rows: n/128, at least 8 warps (256/H
# rows), at most R.
@pytest.mark.parametrize("word,blocks,hidden,n,lanes,rows,resident,nbytes", [
    # the demo (3 blocks, H=16) at N 16: one tile of 16 rows, the 6
    # couplings resident (21,888 bytes)
    (F32, 3, 16, 16, True, 16, True, 4 * 6 * 2 * 456),
    (F32, 3, 16, 300, True, 16, True, 4 * 6 * 2 * 456),
    # its switch: 4,096 rows are 64 tiles of 64 (run as 128 tiles of 32),
    # one more row the row tile
    (F32, 3, 16, 4096, True, 32, True, 4 * 6 * 2 * 456),
    (F32, 3, 16, 4097, False, 128, True, 4 * 6 * 2 * 420),
    (F32, 3, 16, 262144, False, 128, True, 4 * 6 * 2 * 420),
    # the reference default (10 blocks, H=32) at N 256: 32 tiles of 8
    # rows; its 20 couplings (226,560 bytes) take two slots
    (F32, 10, 32, 256, True, 8, False, 4 * 2 * 2 * 1416),
    (F32, 10, 32, 2048, True, 16, False, 4 * 2 * 2 * 1416),
    (F32, 10, 32, 2049, False, 128, False, 4 * 2 * 2 * 1348),
    # float64: the demo's 43,776 bytes still fit
    (F64, 3, 16, 16, True, 16, True, 8 * 6 * 2 * 456),
    (F64, 3, 16, 2048, True, 16, True, 8 * 6 * 2 * 456),
    (F64, 3, 16, 2049, False, 128, True, 8 * 6 * 2 * 420),
    # 4 blocks at H=16 (8 couplings, 58,368 bytes) do not
    (F64, 4, 16, 16, True, 16, False, 8 * 2 * 2 * 456),
    (F64, 10, 32, 256, True, 8, False, 8 * 2 * 2 * 1416),
    (F64, 10, 32, 1024, True, 8, False, 8 * 2 * 2 * 1416),
    (F64, 10, 32, 1025, False, 128, False, 8 * 2 * 2 * 1348),
])
def test_forward_tile_and_shared_memory_match_hand_counts(
        word, blocks, hidden, n, lanes, rows, resident, nbytes):
    assert cc.fwd_plan(blocks, 3, hidden, word, n) == (lanes, rows,
                                                       resident, nbytes)


def test_forward_shared_memory_check(monkeypatch):
    """Every stack within the kernels' bounds passes K4's shared-memory
    check at any batch and any number of blocks, as before it had one: the
    largest need (float64, H=32, 4 layers, the lane tile, two couplings)
    is 4·2,504 words, 80,128 bytes. Under a smaller cap the check raises
    before any launch."""
    need = []
    for word in (F32, F64):
        for hidden in (8, 16, 32):
            for depth in (2, 3, 4):
                for blocks in (1, 2, 3, 10, 400):
                    for n in (1, 16, 300, 2048, 2049, 8193, 10**6):
                        need.append(cc.fwd_plan(blocks, depth, hidden, word,
                                                n).bytes)
    assert max(need) == 80128 <= cc.KERNEL_MAX_SMEM
    for d in (2, 5, 8):
        for dtype in (torch.float32, torch.float64):
            flow = nft.realnvp(torch.Generator().manual_seed(0), d, (32, 32),
                               nlayers=2, dtype=dtype, fused=True,
                               device="cpu")
            fb = flow.bijector.bijectors[0]
            sels = cc._sels(fb.idx_even, fb.idx_odd, d)
            leaves = cc._leaves(fb.groups)
            for n in (16, 4096, 4097):
                x = torch.zeros((n, d), dtype=dtype)
                with pytest.raises(ValueError, match="CUDA device"):
                    cc._kernel_args(x, leaves, sels, 3)
    monkeypatch.setattr(cc, "KERNEL_MAX_SMEM", 8 * 4 * 1416 - 1)
    with pytest.raises(ValueError, match="two staged couplings need 45312 "
                                         "bytes"):
        cc._kernel_args(torch.zeros((16, 8), dtype=torch.float64), leaves,
                        sels, 3)


def test_policy_constants_match_the_device_header():
    """csrc/coupling_mma.cuh's shared-memory cap is the one the wrapper
    holds the policy's K5 to, and its CTAs are four warps of 16 rows
    (benchmarks/torch_ab.py rewrites the warps' line in its copies)."""
    text = (ROOT / "normalizingflows_torch" / "csrc"
            / "coupling_mma.cuh").read_text()
    assert cc.KERNEL_MAX_SMEM == 227 * 1024
    for line in ("constexpr int kMmaMaxSmem = 227 * 1024;",
                 "constexpr int kMmaRows = 16;",
                 "constexpr int kMmaWarps = 4;",
                 "constexpr int kMmaMaxWarps = 8;"):
        assert line in text, line


def test_policy_launches_hand_the_entries_their_plan(monkeypatch):
    """Under the policy `_launch_fwd` passes the C entry no tile (lanes 0:
    the tensor-core kernel has one) and `_launch_bwd` one CTA per 64 rows;
    float32 keeps its lane tile and K5's lane-tile CTAs."""
    import contextlib
    import types

    from normalizingflows_torch.ops import _build

    calls = []

    class Lib:
        @staticmethod
        def coupling_mma_plan(d, n_blocks, depth, widths, backward, out):
            out[0], out[1] = 64, 1024  # the C entry's rows and bytes
            return 0

        def __getattr__(self, name):
            return lambda *a: calls.append((name, a)) or 0

    real = cc._kernel_args

    def kernel_args(x, leaves, sels, depth, backward=False,
                    train_batch=None, compute_dtype=None):
        with pytest.raises(ValueError, match="CUDA device"):
            real(x, leaves, sels, depth, backward, train_batch,
                 compute_dtype)
        # the C interface's widths (per group n_B, hidden..., n_A)
        return (cc.KERNEL_TYPES[(x.dtype, compute_dtype)],
                [1, 16, 16, 1] * 2, None)

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(cc, "_kernel_args", kernel_args)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    flow = nft.realnvp(torch.Generator().manual_seed(0), 2, (16, 16),
                       nlayers=3, fused=True, device="cpu")
    fb = flow.bijector.bijectors[0]
    sels = cc._sels(fb.idx_even, fb.idx_odd, 2)
    leaves = [t.detach() for t in cc._leaves(fb.groups)]
    x, gld = torch.zeros((300, 2)), torch.zeros(300)
    for cd in (torch.bfloat16, None):
        cc._launch_fwd(x, leaves, sels, 3, False, compute_dtype=cd)
        cc._launch_bwd(x, leaves, x, gld, sels, 3, False, cd)
    (f16, a), (b16, b), (f32, c), (b32, e) = calls
    assert (f16, b16) == ("coupling_fwd_f32_cbf16", "coupling_bwd_f32_cbf16")
    assert a[10] == 0 and b[13] == 5  # no tile; 300 rows in 64-row CTAs
    assert (f32, b32) == ("coupling_fwd_f32", "coupling_bwd_f32")
    assert c[10] == 1 and e[13] == 19  # the lane tiles: 16 rows a CTA


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv,want", [
    ([], set(range(1, 61))),
    (["--phases", "1,2,12,18-21"], {1, 2, 12, 18, 19, 20, 21}),
    (["--phases", "22-26"], {1, 22, 23, 24, 25, 26}),
    (["--phases", "27-31"], {1, 27, 28, 29, 30, 31}),
    (["--phases", "31"], {1, 27, 28, 31}),
    (["--phases", "32-37"], {1, 32, 33, 34, 35, 36, 37}),
    (["--phases", "38-42"], {1, 38, 39, 40, 41, 42}),
    (["--phases", "43-45"], {1, 43, 44, 45}),
    (["--phases", "46-51"], {1, 46, 47, 48, 49, 50, 51}),
    (["--phases", "1,2,52-54"], {1, 2, 52, 53, 54}),
    (["--phases", "55-58"], {1, 55, 56, 57, 58}),
    (["--phases", "59"], {1, 59}),
    (["--phases", "1,2,47,51,59,60"], {1, 2, 47, 51, 59, 60}),
    (["--phases", "12"], {1, 12}),
    (["--phases", "7,15"], {1, 5, 7, 14, 15}),
])
def test_chip_smoke_phase_selection(argv, want):
    cs = _chip_smoke()
    assert cs.selected_phases(argv) == want


@pytest.mark.parametrize("text", ["0", "61", "3-1", "x", "1,,2", "-3",
                                  "1-", "60-61"])
def test_chip_smoke_rejects_bad_phases(text):
    cs = _chip_smoke()
    with pytest.raises(ValueError):
        cs.parse_phases(text)
    with pytest.raises(SystemExit):
        cs.selected_phases(["--phases", text])


def _phase12_demo():
    """Phase 12's demo stack on the CPU: `realnvp(2, (16, 16), nlayers=3,
    fused=True)` of seed 30 with noise 0.1 on every parameter."""
    flow = nft.realnvp(torch.Generator().manual_seed(30), 2, (16, 16),
                       nlayers=3, fused=True, device="cpu")
    noise = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=noise))
    fb = flow.bijector.bijectors[0]
    return fb, cc._sels(fb.idx_even, fb.idx_odd, 2)


def test_chip_smoke_draws_phase12_rows_off_the_kinks(monkeypatch):
    """`_off_kinks` draws again exactly the rows `_kink_rows` flags, until
    none is flagged (a wide KINK flags many)."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "KINK", 1e-4)
    fb, sels = _phase12_demo()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((512, 2), generator=gen)
    near = cs._kink_rows(cc, x, fb.groups, sels)
    assert 0 < int(near.sum()) < 512
    got, draws = cs._off_kinks(cc, x.clone(), fb.groups, sels, gen)
    assert draws >= int(near.sum())
    assert torch.equal(got[~near], x[~near])
    assert not torch.equal(got[near], x[near])
    assert not cs._kink_rows(cc, got, fb.groups, sels).any()


@pytest.mark.parametrize("inverse", [False, True])
def test_k5_gx_rows_outside_phase12_tolerance_sit_at_kinks(inverse):
    """The plain K5 in float32 against itself in float64, at phase 12's
    gx tolerance (rtol 2e-3, atol 1e-4/N) on 65,536 rows: every row
    outside it (this draw has one in each direction) has a pre-activation
    at the leaky ReLU's kink, and on rows drawn off the kinks none is
    outside."""
    cs = _chip_smoke()
    fb, sels = _phase12_demo()
    g64 = {grp: {net: [(W.double(), b.double())
                       for W, b in fb.groups[grp][net]] for net in ("s", "t")}
           for grp in ("even", "odd")}
    n = 65536
    gen = torch.Generator().manual_seed(105)
    x = torch.randn((n, 2), generator=gen)
    gy = torch.randn((n, 2), generator=gen) / n
    gld = torch.randn((n,), generator=gen) / n

    def outside(x):
        with torch.no_grad():
            g32 = cc.tile_flow_bwd(x, fb.groups, gy, gld, sels, inverse)[0]
            g64_ = cc.tile_flow_bwd(x.double(), g64, gy.double(),
                                    gld.double(), sels, inverse)[0]
        return ((g32.double() - g64_).abs()
                > 1e-4 / n + 2e-3 * g64_.abs()).any(1)

    bad = outside(x)
    near = cs._kink_rows(cc, x, fb.groups, sels)
    assert bad.any() and not (bad & ~near).any()
    assert not outside(cs._off_kinks(cc, x, fb.groups, sels, gen)[0]).any()
