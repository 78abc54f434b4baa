"""The port's whole-run RealNVP training (`experimental/train_cuda.py`,
`train_realnvp_fused`) against the JAX package's.

On the CPU the port runs K6's plain version (`adam_train_plain`, what
`adam_train_realnvp_fused` runs for CPU tensors). The JAX side runs the
Pallas `adam_train_realnvp_fused` in interpret mode under `jax.jit`, with
the Banana log-density written with Python-scalar constants as its
contract asks (tests/test_train_kernel.py). Both get the same base draws,
made with numpy from a seed, and the same perturbed weights
(`load_jax_params`). Compared: the loss trajectory and every trained leaf,
against JAX's kernel in one launch and in chunks of 4 (the global-step bias
correction); the steps, draws and losses the port's wrapper hands each
launch; the entry point `train_realnvp_fused`; its argument checks and the kernel
path's refusals on CPU tensors; the plain version's manual gradient
against autograd; and its trajectory against `torch.optim.Adam` on the
fused flow's eager step.

Tolerances: training trajectories those of tests/test_torch_coupling.py
(f64 rtol 1e-8 atol 1e-12, f32 rtol 1e-4 atol 1e-5); gradients f64 rtol
1e-10 atol 1e-12, f32 the JAX suite's (rtol 2e-3, atol 1e-4).
"""

import contextlib
import copy
import math
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.experimental.train_pallas import (  # noqa: E402
    adam_train_realnvp_fused as jax_train,
)
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.experimental import coupling_cuda as cc  # noqa
from normalizingflows_torch.experimental import train_cuda as tc  # noqa
from normalizingflows_torch.ops import launches  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TRAIN_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-8, 1e-12)}
GRAD_TOL = {"f32": (2e-3, 1e-4), "f64": (1e-10, 1e-12)}
STEPS, BATCH, LR = 10, 16, 5e-4


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _pair(dt, d=2, hdims=(16, 16), nlayers=3, seed=0):
    """The demo model (fused) in JAX, its weights moved off zero by noise
    0.1, and the port's copy."""
    jdt, tdt, _ = DT[dt]
    jflow = nf.realnvp(jax.random.key(seed), d, hdims, nlayers=nlayers,
                       dtype=jdt, fused=True, interpret=True)
    rng = np.random.default_rng(seed + 1)
    jflow = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                        a.dtype), jflow)
    tflow = nft.realnvp(torch.Generator().manual_seed(seed), d, hdims,
                        nlayers=nlayers, dtype=tdt, fused=True, device="cpu")
    load_jax_params(tflow, jax_arrays(jflow))
    return jflow, tflow


def _draws(dt, shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        DT[dt][2])


def _banana_logp_static(b, var, d):
    """Banana's log-density with Python-scalar constants (the JAX kernel's
    contract for in-kernel targets)."""
    log_z = 0.5 * (d * math.log(2 * math.pi) + math.log(var))

    def logp(x):
        z2 = x[..., 1] + b * jnp.square(x[..., 0]) - var * b
        quad = (jnp.square(x[..., 0]) / var + jnp.square(z2)
                + jnp.sum(jnp.square(x[..., 2:]), axis=-1))
        return -log_z - 0.5 * quad

    return logp


def _close(a, b, tol, msg=""):
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol[0], atol=tol[1],
                               err_msg=msg)


# (a, b) the run against JAX's kernel, in one launch and in chunks of 4
@pytest.mark.parametrize("dt,chunk", [("f64", 512), ("f32", 512),
                                      ("f64", 4)])
def test_train_run_matches_jax_kernel(dt, chunk):
    jflow, tflow = _pair(dt)
    jb, tb = jflow.bijector.bijectors[0], tflow.bijector.bijectors[0]
    xs = _draws(dt, (STEPS, BATCH, 2))
    logp = _banana_logp_static(1.0, 100.0, 2)

    @jax.jit
    def jax_side(xs, groups, loc, scale):
        return jax_train(xs, groups, jb.idx_even, jb.idx_odd, logp, loc,
                         scale, LR, interpret=True, chunk=chunk)

    groups_j, losses_j = jax_side(jnp.asarray(xs), jb.groups, jflow.base.loc,
                                  jflow.base.scale)
    args = (torch.from_numpy(xs), tb.groups, tb.idx_even, tb.idx_odd,
            nft.Banana(2, 1.0, 100.0), tflow.base.loc, tflow.base.scale, LR)
    groups_t, losses_t = tc.adam_train_realnvp_fused(*args, chunk=chunk)
    tol = TRAIN_TOL[dt]
    _close(losses_t, losses_j, tol, "losses")
    leaves_j = jax.tree_util.tree_leaves(groups_j)
    leaves_t = cc._leaves(groups_t)
    assert len(leaves_t) == len(leaves_j) == 4 * 2 * 3
    for i, (a, b) in enumerate(zip(leaves_t, leaves_j)):
        _close(a, b, tol, f"leaf {i}")
    # the weights moved, and the input groups were left as they were
    for a, b in zip(leaves_t, cc._leaves(tb.groups)):
        assert not torch.equal(a, b)
    for a, b in zip(cc._leaves(tb.groups),
                    jax.tree_util.tree_leaves(jb.groups)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


# (b) the port's side of the chunks: each launch gets its own steps' draws
# and losses and its global first step; that K6 then gives the same bits in
# chunks as in one launch is checked on the card (chip_smoke.py phase 18)
@pytest.mark.parametrize("n_steps,chunk,want", [
    (10, 4, [(0, 4), (4, 4), (8, 2)]), (6, 512, [(0, 6)])])
def test_launches_cover_the_run_in_order(n_steps, chunk, want, monkeypatch):
    from normalizingflows_torch.ops import _build

    calls = []

    def fake_kernel(xs_p, w, m, v, grad, losses_p, loc, scale, steps, step0,
                    batch, d, *rest):
        calls.append((xs_p, losses_p, steps, step0, batch, d))
        return 0

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        realnvp_train_f64=fake_kernel))
    # the shape checks want CUDA tensors (test_kernel_path_refuses_...)
    monkeypatch.setattr(tc, "_kernel_args",
                        lambda *a, **kw: ("f64", None, None))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    launches.reset()
    flow = nft.realnvp(torch.Generator().manual_seed(0), 2, (8, 8),
                       nlayers=2, dtype=torch.float64, fused=True,
                       device="cpu")
    fb = flow.bijector.bijectors[0]
    xs = torch.zeros((n_steps, 3, 2), dtype=torch.float64)
    run, leaves = tc._prepare(xs, fb.groups, fb.idx_even, fb.idx_odd,
                              nft.Banana(2), flow.base.loc, flow.base.scale,
                              LR, 0.9, 0.999, 1e-8)
    _, losses = tc._launch(xs, leaves, run, chunk)
    assert [(c[3], c[2]) for c in calls] == want
    for xs_p, losses_p, steps, step0, batch, d in calls:
        assert (batch, d) == (3, 2)
        assert xs_p == xs.data_ptr() + step0 * 3 * 2 * xs.element_size()
        assert losses_p == losses.data_ptr() + step0 * losses.element_size()
    assert launches.counts()["realnvp_train"] == len(want)


# (c) the entry point
def test_train_realnvp_fused_trains_in_place():
    _, flow = _pair("f64")
    fb = flow.bijector.bijectors[0]
    params = list(flow.parameters())
    before = [p.detach().clone() for p in params]
    start = copy.deepcopy(fb.groups)
    target = nft.Banana(2, 1.0, 100.0)
    res = nft.train_realnvp_fused(torch.Generator().manual_seed(4), flow,
                                  target, BATCH, max_iters=6,
                                  learning_rate=LR, chunk=4)
    assert res.flow is flow and res.state.flow is flow
    assert res.state.iteration == 6 and res.state.opt_state is None
    assert res.stats["loss"].shape == (6,)
    np.testing.assert_array_equal(res.stats["iteration"], np.arange(1, 7))
    assert [id(p) for p in flow.parameters()] == [id(p) for p in params]
    # the base is frozen; every weight of the stack moved
    for (name, p), b in zip(flow.named_parameters(), before):
        assert torch.equal(p, b) == name.startswith("base."), name
    # the same run from the same draws, by the plain version
    xs = flow.base.sample(torch.Generator().manual_seed(4), (6, BATCH))
    groups, losses = tc.adam_train_plain(
        xs.detach(), start, fb.idx_even, fb.idx_odd, target, flow.base.loc,
        flow.base.scale, LR)
    np.testing.assert_array_equal(res.stats["loss"], losses.numpy())
    for a, b in zip(cc._leaves(fb.groups), cc._leaves(groups)):
        assert torch.equal(a, b)
    # the trained flow still samples and evaluates its density
    with torch.no_grad():
        s = flow.sample(torch.Generator().manual_seed(5), (8,))
        lp = flow.log_prob(s)
    assert s.shape == (8, 2) and lp.shape == (8,)
    assert bool(torch.isfinite(lp).all())


# (d) what the entry point refuses
@pytest.mark.parametrize("case,match", [
    ("unfused", "fused=True"), ("base", "DiagNormal"),
    ("target", "Banana"), ("dim", "dimension"),
    ("cross", "JAX's kernel refuses"), ("mixture", "JAX's kernel refuses")])
def test_train_realnvp_fused_rejects(case, match):
    g = torch.Generator().manual_seed(0)
    kw = dict(nlayers=2, dtype=torch.float64, device="cpu")
    target = nft.Banana(2, 1.0, 100.0).log_prob
    if case == "unfused":
        flow = nft.realnvp(g, 2, (8, 8), **kw)
    elif case == "base":
        flow = nft.realnvp(g, nft.StandardNormal(2, torch.float64, "cpu"),
                           (8, 8), fused=True, **kw)
    else:
        flow = nft.realnvp(g, 2, (8, 8), fused=True, **kw)
        target = {
            "target": lambda: lambda y: -0.5 * y.square().sum(-1),
            "dim": lambda: nft.Banana(3, 1.0, 100.0),
            # the mixtures JAX's kernel cannot capture (their arrays)
            "cross": lambda: nft.Cross(device="cpu"),
            "mixture": lambda: nft.GaussianMixture(
                torch.zeros(2, 2), torch.ones(2, 2), torch.full((2,), 0.5),
                device="cpu").log_prob}[case]()
    with pytest.raises(ValueError, match=match):
        nft.train_realnvp_fused(g, flow, target, 4, max_iters=2)


# (e) the kernel path on CPU tensors: it raises, and builds nothing
@pytest.mark.parametrize("case", ["backend", "smem"])
def test_kernel_path_refuses_before_any_step(case, monkeypatch):
    from normalizingflows_torch.ops import _build

    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(_build, "library", no_build)
    launches.reset()
    if case == "backend":
        _, flow = _pair("f64")
        match, d, blocks = "CUDA", 2, None
    else:
        # K6 keeps K5's layout: at d=8 with [32,32] float64 and batch 16
        # (one 16-row tile) it takes 91 blocks
        flow = nft.realnvp(torch.Generator().manual_seed(0), 8, (32, 32),
                           nlayers=92, dtype=torch.float64, fused=True,
                           device="cpu")
        match, d, blocks = "at most 91 blocks", 8, 92
    fb = flow.bijector.bijectors[0]
    assert blocks is None or fb.groups["even"]["s"][0][0].shape[0] == blocks
    xs = torch.zeros((3, 16, d), dtype=torch.float64)
    args = (xs, fb.groups, fb.idx_even, fb.idx_odd, nft.Banana(d),
            flow.base.loc, flow.base.scale, LR)
    with pytest.raises(ValueError, match=match):
        if case == "backend":
            tc.adam_train_realnvp_fused(*args, backend="cuda")
        else:
            run, leaves = tc._prepare(*args, 0.9, 0.999, 1e-8)
            tc._launch(xs, leaves, run, 512)
    with pytest.raises(ValueError, match="backend"):
        tc.adam_train_realnvp_fused(*args, backend="triton")
    assert launches.counts()["realnvp_train"] == 0


# (f) the plain version's manual gradient against autograd
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_plain_gradient_matches_autograd(dt):
    _, flow = _pair(dt, d=5, hdims=(8, 8), nlayers=2, seed=6)
    fb = flow.bijector.bijectors[0]
    target = nft.Banana(5, 1.0, 10.0)
    x = torch.from_numpy(_draws(dt, (70, 5), seed=7))
    run, leaves = tc._prepare(x[None], fb.groups, fb.idx_even, fb.idx_odd,
                              target, flow.base.loc, flow.base.scale, LR,
                              0.9, 0.999, 1e-8)
    loss, grads = tc._loss_and_grads(x, leaves, run)
    w = [t.detach().clone().requires_grad_() for t in leaves]
    y, ld = cc.tile_flow(x, cc._unflatten(w, run.depth), run.sels)
    ref = -(target.log_prob(y) - flow.base.log_prob(x) + ld).mean()
    tape = torch.autograd.grad(ref, w)
    _close(loss, ref.detach().numpy(), TRAIN_TOL[dt], "loss")
    assert len(grads) == len(tape) == 4 * 2 * 3
    for i, (a, b) in enumerate(zip(grads, tape)):
        _close(a, b.numpy(), GRAD_TOL[dt], f"leaf {i}")


# the run against torch.optim.Adam on the fused flow's eager step
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_plain_run_matches_eager_adam(dt):
    _, flow = _pair(dt, seed=8)
    fb = flow.bijector.bijectors[0]
    target = nft.Banana(2, 1.0, 100.0)
    xs = torch.from_numpy(_draws(dt, (8, BATCH, 2), seed=9))
    groups, losses = tc.adam_train_plain(
        xs, fb.groups, fb.idx_even, fb.idx_odd, target, flow.base.loc,
        flow.base.scale, LR)
    opt = torch.optim.Adam(fb.parameters(), lr=LR)
    eager = []
    for x in xs:
        opt.zero_grad()
        loss = -nft.elbo_from_samples(x, flow, target.log_prob)
        loss.backward()
        opt.step()
        eager.append(float(loss.detach()))
    tol = TRAIN_TOL[dt]
    _close(losses, eager, tol, "losses")
    for i, (a, b) in enumerate(zip(cc._leaves(groups),
                                   cc._leaves(fb.groups))):
        _close(a, b.detach().numpy(), tol, f"leaf {i}")
