"""The port's whole-run RealNVP training (`experimental/train_cuda.py`) on
the targets JAX's kernel takes besides Banana, and on bfloat16 parameters.

On the CPU the port runs K6's plain version (`adam_train_plain`, what
`adam_train_realnvp_fused` runs for CPU tensors). The JAX side runs the
Pallas `adam_train_realnvp_fused` in interpret mode under `jax.jit` with
the target's own bound ``log_prob`` (its gradient by `jax.vjp` inside the
kernel), on the same numpy draws and the same perturbed weights
(`load_jax_params`). Compared: for Funnel at d = 2 and d = 5 and
WarpedGauss with and without ``ref_compat``, the loss trajectory and every
trained leaf, in one launch and in chunks of 4; the plain version's
written-out gradient against autograd of the port's ``log_prob``; and what
the wrapper hands the kernel for each target (a fake library entry).

bfloat16 parameters: JAX's K6 computes Adam's bias corrections in
bfloat16, where 1 − 0.999 rounds to 0 at t = 1, so its run turns NaN; the
port computes them in float32 (optax.adam's intent). The port's bfloat16
run is held against a float32 run on the same bfloat16 weights and draws,
and its error must be no larger than that of a jitted `lax.scan` of
`optax.adam` on JAX's bfloat16 flow and the same draws (the
tests/test_torch_bf16.py rule: 1.5× JAX's max relative error plus 2^-8).

Tolerances: training trajectories those of tests/test_torch_train_kernel.py
(f64 rtol 1e-8 atol 1e-12, f32 rtol 1e-4 atol 1e-5); gradients f64 rtol
1e-10 atol 1e-12, f32 the JAX suite's (rtol 2e-3, atol 1e-4).
"""

import contextlib
import types

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
from normalizingflows.jl_tpu.experimental.train_pallas import (  # noqa: E402
    adam_train_realnvp_fused as jax_train,
)
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.experimental import coupling_cuda as cc  # noqa
from normalizingflows_torch.experimental import train_cuda as tc  # noqa
from normalizingflows_torch.ops import launches  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

BF = torch.bfloat16
DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TRAIN_TOL = {"f32": (1e-4, 1e-5), "f64": (1e-8, 1e-12)}
GRAD_TOL = {"f32": (2e-3, 1e-4), "f64": (1e-10, 1e-12)}
ONE_ROUNDING = 2.0 ** -8  # a float32 value rounded once to bfloat16
STEPS, BATCH, LR = 10, 16, 5e-4

# (JAX target, the port's, the flow's dimension)
TARGETS = {
    "funnel2": (lambda: nf.Funnel(2, 0.0, 3.0),
                lambda: nft.Funnel(2, 0.0, 3.0), 2),
    "funnel5": (lambda: nf.Funnel(5, 0.0, 3.0),
                lambda: nft.Funnel(5, 0.0, 3.0), 5),
    "warped": (lambda: nf.WarpedGauss(1.0, 0.12),
               lambda: nft.WarpedGauss(1.0, 0.12), 2),
    "warped_ref": (lambda: nf.WarpedGauss(1.0, 0.12, ref_compat=True),
                   lambda: nft.WarpedGauss(1.0, 0.12, ref_compat=True), 2),
}


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                        a.dtype), tree)


def _pair(dt, d=2, hdims=(16, 16), nlayers=2, seed=0, jdt=None, tdt=None):
    """A fused RealNVP in JAX, its weights moved off zero by noise 0.1, and
    the port's copy."""
    jdt = jdt or DT[dt][0]
    tdt = tdt or DT[dt][1]
    jflow = nf.realnvp(jax.random.key(seed), d, hdims, nlayers=nlayers,
                       dtype=jdt, fused=True, interpret=True)
    jflow = _perturb(jflow, seed + 1)
    tflow = nft.realnvp(torch.Generator().manual_seed(seed), d, hdims,
                        nlayers=nlayers, dtype=tdt, fused=True, device="cpu")
    load_jax_params(tflow, jax_arrays(jflow))
    return jflow, tflow


def _draws(shape, seed=3, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _np(a):
    """A torch or JAX array as numpy, bfloat16 widened to float32."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.float() if a.dtype == BF else a).numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol[0], atol=tol[1],
                               err_msg=msg)


def _args(tflow, xs, target):
    fb = tflow.bijector.bijectors[0]
    return (torch.as_tensor(xs), fb.groups, fb.idx_even, fb.idx_odd,
            target, tflow.base.loc, tflow.base.scale, LR)


# the run against JAX's kernel on each target, f64 and f32, and in chunks
@pytest.mark.parametrize("name,dt,chunk", [
    ("funnel2", "f64", 512), ("funnel2", "f32", 512), ("funnel2", "f64", 4),
    ("funnel5", "f64", 512), ("funnel5", "f32", 512),
    ("warped", "f64", 512), ("warped", "f32", 512),
    ("warped_ref", "f64", 512), ("warped_ref", "f32", 512)])
def test_train_run_matches_jax_kernel_on_target(name, dt, chunk):
    make_j, make_t, d = TARGETS[name]
    jflow, tflow = _pair(dt, d, (8, 8) if d > 2 else (16, 16), seed=11)
    jb = jflow.bijector.bijectors[0]
    xs = _draws((STEPS, BATCH, d), seed=12, dtype=DT[dt][2])
    logp = make_j().log_prob

    @jax.jit
    def jax_side(xs, groups, loc, scale):
        return jax_train(xs, groups, jb.idx_even, jb.idx_odd, logp, loc,
                         scale, LR, interpret=True, chunk=chunk)

    groups_j, losses_j = jax_side(jnp.asarray(xs), jb.groups, jflow.base.loc,
                                  jflow.base.scale)
    target = make_t()
    groups_t, losses_t = tc.adam_train_realnvp_fused(
        *_args(tflow, xs, target.log_prob if name == "warped" else target),
        chunk=chunk)
    tol = TRAIN_TOL[dt]
    assert bool(torch.isfinite(losses_t).all())
    _close(losses_t, losses_j, tol, "losses")
    leaves_j = jax.tree_util.tree_leaves(groups_j)
    leaves_t = cc._leaves(groups_t)
    assert len(leaves_t) == len(leaves_j) == 4 * 2 * 3
    for i, (a, b) in enumerate(zip(leaves_t, leaves_j)):
        _close(a, b, tol, f"leaf {i}")
    for a, b in zip(leaves_t, cc._leaves(tflow.bijector.bijectors[0].groups)):
        assert not torch.equal(a, b)


# the plain version's written-out gradient against autograd of log_prob
@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("name", ["funnel5", "warped", "warped_ref"])
def test_plain_gradient_matches_autograd_on_target(name, dt):
    _, make_t, d = TARGETS[name]
    _, flow = _pair(dt, d, (8, 8), seed=6)
    fb = flow.bijector.bijectors[0]
    target = make_t()
    x = torch.from_numpy(_draws((70, d), seed=7, dtype=DT[dt][2]))
    run, leaves = tc._prepare(x[None], fb.groups, fb.idx_even, fb.idx_odd,
                              target, flow.base.loc, flow.base.scale, LR,
                              0.9, 0.999, 1e-8)
    y = cc.tile_flow(x, fb.groups, run.sels)[0].detach()
    # the target's log-density and score, written out, against the port's
    log_p, dlog_p = tc._log_p_and_grad(y, run)
    _close(log_p, target.log_prob(y), TRAIN_TOL[dt], "log p")
    _close(dlog_p, target.score(y), GRAD_TOL[dt], "score")
    loss, grads = tc._loss_and_grads(x, leaves, run)
    w = [t.detach().clone().requires_grad_() for t in leaves]
    y, ld = cc.tile_flow(x, cc._unflatten(w, run.depth), run.sels)
    ref = -(target.log_prob(y) - flow.base.log_prob(x) + ld).mean()
    tape = torch.autograd.grad(ref, w)
    _close(loss, ref.detach(), TRAIN_TOL[dt], "loss")
    assert len(grads) == len(tape) == 4 * 2 * 3
    for i, (a, b) in enumerate(zip(grads, tape)):
        _close(a, b, GRAD_TOL[dt], f"leaf {i}")


# what the wrapper hands K6 for each target and dtype (a fake entry)
@pytest.mark.parametrize("name,dtype,want_id,want_consts", [
    ("banana", torch.float64, 0,
     (1.0, 100.0, 0.5 * (2 * tc._LOG_2PI + np.log(100.0)), 0.0)),
    ("funnel5", torch.float32, 1,
     (0.0, 3.0, 2.0, 2.5 * tc._LOG_2PI + np.log(3.0))),
    ("warped_ref", BF, 2,
     (1.0, 0.12, tc._LOG_2PI + np.log(1.0) + np.log(0.12), 1.0))])
def test_launch_hands_the_target_to_the_kernel(name, dtype, want_id,
                                               want_consts, monkeypatch):
    from normalizingflows_torch.ops import _build

    d = 5 if name == "funnel5" else 2
    target = (nft.Banana(2, 1.0, 100.0) if name == "banana"
              else TARGETS[name][1]())
    sfx = {torch.float64: "f64", torch.float32: "f32", BF: "bf16"}[dtype]
    calls = []

    def fake_kernel(xs_p, w, m, v, grad, *rest):
        calls.append((grad, rest))
        return 0

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        **{f"realnvp_train_{sfx}": fake_kernel}))
    monkeypatch.setattr(tc, "_kernel_args",
                        lambda *a, **kw: (sfx, None, None))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty
    grads = []

    def spy_empty_like(t, **kw):  # the gradient buffer's dtype
        out = torch.zeros(t.shape, dtype=kw.get("dtype", t.dtype))
        grads.append(out)
        return out

    monkeypatch.setattr(torch, "empty_like", spy_empty_like)
    launches.reset()
    flow = nft.realnvp(torch.Generator().manual_seed(0), d, (8, 8),
                       nlayers=2, dtype=dtype, fused=True, device="cpu")
    fb = flow.bijector.bijectors[0]
    xs = empty((6, 3, d), dtype=dtype).zero_()
    run, leaves = tc._prepare(xs, fb.groups, fb.idx_even, fb.idx_odd,
                              target, flow.base.loc, flow.base.scale, LR,
                              0.9, 0.999, 1e-8)
    assert (run.target, run.consts) == (want_id, pytest.approx(want_consts))
    tc._launch(xs, leaves, run, 4)
    assert len(calls) == 2
    for _, rest in calls:
        target_arg, hyper = rest[-3], rest[-2]
        assert target_arg == want_id
        np.testing.assert_allclose(list(hyper), [LR, 0.9, 0.999, 1e-8,
                                                 *want_consts])
    # bfloat16 storage keeps its gradient buffer in float32
    assert grads[-1].dtype == (torch.float32 if dtype == BF else dtype)
    counted = launches.name_of("realnvp_train", sfx)
    assert launches.counts()[counted] == 2
    assert counted == ("realnvp_train_bf16" if dtype == BF
                       else "realnvp_train")


# what K6 refuses before any step: other targets and dimensions
@pytest.mark.parametrize("case,match", [
    ("cross", "JAX's kernel"), ("mixture", "JAX's kernel"),
    ("mixture_log_prob", "JAX's kernel"), ("score", "Funnel or"),
    ("warped_d5", "dimension 2 for a flow of dimension 5"),
    ("funnel9", "2 <= d <= 8")])
def test_prepare_refuses_other_targets(case, match, monkeypatch):
    from normalizingflows_torch.ops import _build

    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(_build, "library", no_build)
    d = {"warped_d5": 5, "funnel9": 9}.get(case, 2)
    target = {
        "cross": lambda: nft.Cross(device="cpu"),
        "mixture": lambda: nft.GaussianMixture(
            torch.zeros(3, 2), torch.ones(3, 2), torch.full((3,), 1 / 3),
            device="cpu"),
        "mixture_log_prob": lambda: nft.Cross(device="cpu").log_prob,
        "score": lambda: nft.Funnel(2).score,
        "warped_d5": lambda: nft.WarpedGauss(),
        "funnel9": lambda: nft.Funnel(9)}[case]()
    flow = nft.realnvp(torch.Generator().manual_seed(0), d, (8, 8),
                       nlayers=2, dtype=torch.float64, fused=True,
                       device="cpu")
    fb = flow.bijector.bijectors[0]
    xs = torch.zeros((3, 4, d), dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        tc.adam_train_realnvp_fused(xs, fb.groups, fb.idx_even, fb.idx_odd,
                                    target, flow.base.loc, flow.base.scale,
                                    LR)


# ---------------------------------------------------------------------------
# bfloat16 parameters
# ---------------------------------------------------------------------------

def _bf16_case(seed=20, d=2, steps=STEPS):
    """JAX's bfloat16 fused flow, the port's copy, the same flow in float32
    (the bfloat16 values widened) and bfloat16 draws (as float32 values)."""
    jflow, tflow = _pair(None, d, (16, 16), seed=seed, jdt=jnp.bfloat16,
                         tdt=BF)
    _, f32 = _pair(None, d, (16, 16), seed=seed, jdt=jnp.bfloat16,
                   tdt=torch.float32)
    xs = torch.from_numpy(_draws((steps, BATCH, d), seed=seed + 1)).to(BF)
    return jflow, tflow, f32, xs


def test_bf16_first_step_is_the_f32_step_rounded_once():
    """One step on bfloat16 storage is the float32 step on the same values
    with the trained weights and the loss each rounded once."""
    _, tflow, f32, xs = _bf16_case(steps=1)
    target = nft.Banana(2, 1.0, 100.0)
    groups_b, losses_b = tc.adam_train_plain(*_args(tflow, xs, target))
    groups_f, losses_f = tc.adam_train_plain(*_args(f32, xs.float(), target))
    assert losses_b.dtype == BF
    assert torch.equal(losses_b, losses_f.to(BF))
    for a, b in zip(cc._leaves(groups_b), cc._leaves(groups_f)):
        assert a.dtype == BF and torch.equal(a, b.to(BF))


@pytest.mark.parametrize("name", ["banana", "warped"])
def test_bf16_run_no_worse_than_jax_optax(name):
    """10 steps on bfloat16 parameters against the float32 run on the same
    bfloat16 weights and draws: the port's losses and trained weights are
    no further from it than JAX's jitted `optax.adam` scan of its bfloat16
    flow (JAX's own K6 in bfloat16 turns NaN: its bias corrections round
    to 0)."""
    jflow, tflow, f32, xs = _bf16_case()
    target = (nft.Banana(2, 1.0, 100.0) if name == "banana"
              else nft.WarpedGauss(1.0, 0.12))
    logp = (nf.Banana(2, 1.0, 100.0) if name == "banana"
            else nf.WarpedGauss(1.0, 0.12)).log_prob
    groups_b, losses_b = tc.adam_train_plain(*_args(tflow, xs, target))
    xs32 = xs.float()
    groups_f, losses_f = tc.adam_train_plain(*_args(f32, xs32, target))
    assert bool(torch.isfinite(losses_b.float()).all())

    jb = jflow.bijector.bijectors[0]
    opt = optax.adam(LR)

    def loss_fn(groups, x):
        y, ld = jax_cp.coupling_stack_fused(x, groups, jb.idx_even,
                                            jb.idx_odd, interpret=True)
        return -jnp.mean(logp(y) - jflow.base.log_prob(x) + ld)

    @jax.jit
    def scan(groups, xs):
        def body(carry, x):
            g, st = carry
            loss, grads = jax.value_and_grad(loss_fn)(g, x)
            upd, st = opt.update(grads, st, g)
            return (optax.apply_updates(g, upd), st), loss

        (g, _), losses = jax.lax.scan(body, (groups, opt.init(groups)), xs)
        return g, losses

    groups_j, losses_j = scan(jb.groups, jnp.asarray(xs32.numpy(),
                                                     jnp.bfloat16))
    assert losses_j.dtype == jnp.bfloat16

    def rel(a, ref):
        a, ref = _np(a).astype(np.float64), _np(ref).astype(np.float64)
        return float(np.max(np.abs(a - ref) / (np.abs(ref) + 1.0)))

    def no_worse(port, theirs, ref, what):
        e_port, e_jax = rel(port, ref), rel(theirs, ref)
        assert e_port <= 1.5 * e_jax + ONE_ROUNDING, (what, e_port, e_jax)

    no_worse(losses_b, losses_j, losses_f, "losses")
    for i, (a, b, c) in enumerate(zip(cc._leaves(groups_b),
                                      jax.tree_util.tree_leaves(groups_j),
                                      cc._leaves(groups_f))):
        assert a.dtype == BF
        no_worse(a, b, c, f"leaf {i}")


def test_bf16_fused_trainer_stays_finite():
    """`train_realnvp_fused` on a bfloat16 flow (the configuration on which
    JAX's K6 gives NaN from its second step): finite losses, widened to
    float32, that fall; the weights stay bfloat16 and move."""
    flow = nft.realnvp(torch.Generator().manual_seed(0), 2, (16, 16),
                       nlayers=2, fused=True, dtype=BF, device="cpu")
    before = [p.detach().clone() for p in flow.parameters()]
    res = nft.train_realnvp_fused(torch.Generator().manual_seed(1), flow,
                                  nft.Banana(2, 1.0, 100.0), BATCH,
                                  max_iters=20, learning_rate=LR)
    loss = res.stats["loss"]
    assert loss.dtype == np.float32 and loss.shape == (20,)
    assert np.isfinite(loss).all()
    assert loss[-5:].mean() < loss[:5].mean()
    moved = [not torch.equal(p, b) for p, b in zip(flow.parameters(), before)]
    assert {p.dtype for p in flow.parameters()} == {BF} and any(moved)
