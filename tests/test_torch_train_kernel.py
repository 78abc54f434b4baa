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
launch; K6's plan (the cluster's CTAs, the tiles a CTA holds, the scratch
and the shared memory) from its C entries `realnvp_train_plan_*`, built
with g++ against the host emulation of tests/mma_emulation.h, against
hand counts and against the shared-memory cap the wrapper checks, the K6
entries' refusals before a launch, and the scratch the wrapper allocates
from the plan; the entry point
`train_realnvp_fused`; its argument checks and the kernel path's refusals
on CPU tensors; the plain version's manual gradient against autograd; and
its trajectory against `torch.optim.Adam` on the fused flow's eager step.
The kernel's own cluster runs only on the card (chip_smoke.py phases 18,
20 and 52–54).

Tolerances: training trajectories those of tests/test_torch_coupling.py
(f64 rtol 1e-8 atol 1e-12, f32 rtol 1e-4 atol 1e-5); gradients f64 rtol
1e-10 atol 1e-12, f32 the JAX suite's (rtol 2e-3, atol 1e-4).
"""

import contextlib
import copy
import ctypes
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
from normalizingflows_torch.ops import _build, launches  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402
from test_torch_mma_emulated import build_emulated  # noqa: E402

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


def _run_of(flow, batch, steps=1, d=None):
    """(xs, leaves, run) of a K6 run of ``flow`` on zero draws of
    (steps, batch, d) in the flow's dtype, on Banana."""
    fb = flow.bijector.bijectors[0]
    d = d or flow.base.loc.shape[0]
    xs = torch.zeros((steps, batch, d), dtype=flow.base.loc.dtype)
    run, leaves = tc._prepare(xs, fb.groups, fb.idx_even, fb.idx_odd,
                              nft.Banana(d), flow.base.loc, flow.base.scale,
                              LR, 0.9, 0.999, 1e-8)
    return xs, leaves, run


def _fake_library(sfx, plan, calls, clusters=1):
    """A library whose plan entry answers ``plan`` (and ``clusters``) and
    whose K6 entry records its arguments in ``calls``."""
    def plan_entry(d, n_blocks, depth, widths, idx, batch, out):
        out[:5] = [*plan, clusters]
        return 0

    def kernel(*a):
        calls.append(a)
        return 0

    return types.SimpleNamespace(**{f"realnvp_train_{sfx}": kernel,
                                    f"realnvp_train_plan_{sfx}": plan_entry})


def _cpu_launches(monkeypatch, sfx):
    """`train_cuda._launch` on CPU tensors: the shape checks, which want
    CUDA tensors (test_kernel_path_refuses_...), and the device calls
    replaced."""
    monkeypatch.setattr(tc, "_kernel_args",
                        lambda *a, **kw: (sfx, None, None))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))


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
    calls = []
    flow = nft.realnvp(torch.Generator().manual_seed(0), 2, (8, 8),
                       nlayers=2, dtype=torch.float64, fused=True,
                       device="cpu")
    xs, leaves, run = _run_of(flow, 3, n_steps)
    # one CTA: its slice and the cluster's size
    n_params = sum(t.numel() for t in leaves)
    monkeypatch.setattr(_build, "library", lambda: _fake_library(
        "f64", (1, 1, n_params + 1, 0), calls))
    _cpu_launches(monkeypatch, "f64")
    launches.reset()
    _, losses = tc._launch(xs, leaves, run, chunk)
    # (xs, losses, steps, step0, batch, d) of each launch
    calls = [(c[0], c[6], c[9], c[10], c[11], c[12]) for c in calls]
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


# K6's C entries, built with g++ against the host emulation: the plan
# entries answer as on the card (the occupancy query by the emulation's
# rule, `emu_set_clusters` clusters of up to 8 CTAs fit); a launch itself
# is not emulated, and returns cudaErrorNotSupported (801)
TRAIN_MAIN = """#include "mma_emulation.h"
thread_local dim3s threadIdx, blockIdx;
dim3s blockDim, gridDim;
__attribute__((aligned(16))) unsigned char coupling_smem[kEmuSmem];
Barrier g_block_bar;
Warp g_warps[8];
int g_emu_clusters = 16;
#include "train.cu"
#include "train_bf16.cu"
extern "C" void emu_set_clusters(int n) { g_emu_clusters = n; }
"""
SFX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
NOT_EMULATED = 801  # cudaErrorNotSupported: the entry reached its launch


@pytest.fixture(scope="module")
def k6_lib(tmp_path_factory):
    """K6's entries and plan entries, emulated (`TRAIN_MAIN`)."""
    lib = build_emulated(
        tmp_path_factory.mktemp("k6_emulation"), TRAIN_MAIN,
        [f"realnvp_train{k}_{sfx}" for sfx in SFX.values()
         for k in ("", "_plan")], opt="-O0")
    lib.emu_set_clusters.argtypes = [ctypes.c_int]
    yield lib


@contextlib.contextmanager
def _clusters(lib, n):
    """The emulated card holds ``n`` clusters of K6's shape, then 16."""
    lib.emu_set_clusters(n)
    try:
        yield
    finally:
        lib.emu_set_clusters(16)


def _c_stack(flow):
    """(d, n_blocks, depth, widths, idx) of the C interface for the fused
    ``flow``'s stack: per group n_B, the hidden widths, n_A; then the index
    sets."""
    fb = flow.bijector.bijectors[0]
    d, depth = flow.base.loc.shape[0], cc._depth(fb.groups)
    widths = []
    for grp in ("even", "odd"):
        net = fb.groups[grp]["s"]
        widths += [net[0][0].shape[1]] + [W.shape[2] for W, _ in net]
    idx = [i for sel in cc._sels(fb.idx_even, fb.idx_odd, d) for i in sel]
    c_int = ctypes.c_int
    return (d, fb.groups["even"]["s"][0][0].shape[0], depth,
            (c_int * len(widths))(*widths), (c_int * len(idx))(*idx))


# (e) the kernel path on CPU tensors: it raises, and builds or launches
# nothing. "cluster" reaches the emulated library, on which no cluster of
# the plan's 8 CTAs fits
@pytest.mark.parametrize("case,error,match", [
    ("backend", ValueError, "CUDA"),
    ("smem", ValueError, "at most 91 blocks"),
    ("smem_batch", ValueError, "at most 91 blocks"),
    ("cluster", RuntimeError, "no cluster of 8 K6 CTAs")])
def test_kernel_path_refuses_before_any_step(case, error, match, request,
                                             monkeypatch):
    def no_build():
        raise AssertionError("the kernels must not be built")

    monkeypatch.setattr(_build, "library", no_build)
    launches.reset()
    batch = {"smem_batch": 1024, "cluster": 256}.get(case, 16)
    if case.startswith("smem"):
        # K6 keeps K5's layout: at d=8 with [32,32] float64 it takes 91
        # blocks at batch 16 (one 16-row tile) and at 1,024 (8 tiles a
        # CTA)
        flow = nft.realnvp(torch.Generator().manual_seed(0), 8, (32, 32),
                           nlayers=92, dtype=torch.float64, fused=True,
                           device="cpu")
        d, blocks = 8, 92
    else:
        _, flow = _pair("f64")  # 8 tiles of 32 rows at batch 256
        d, blocks = 2, None
    fb = flow.bijector.bijectors[0]
    assert blocks is None or fb.groups["even"]["s"][0][0].shape[0] == blocks
    xs = torch.zeros((3, batch, d), dtype=torch.float64)
    args = (xs, fb.groups, fb.idx_even, fb.idx_odd, nft.Banana(d),
            flow.base.loc, flow.base.scale, LR)
    lib = None
    if case == "cluster":
        lib = request.getfixturevalue("k6_lib")
        monkeypatch.setattr(_build, "library", lambda: lib)
        _, _, _, widths, idx = _c_stack(flow)
        _cpu_launches(monkeypatch, "f64")
        monkeypatch.setattr(tc, "_kernel_args",
                            lambda *a, **kw: ("f64", widths, idx))
    with _clusters(lib, 0) if lib else contextlib.nullcontext():
        with pytest.raises(error, match=match):
            if case == "backend":
                tc.adam_train_realnvp_fused(*args, backend="cuda")
            else:
                run, leaves = tc._prepare(*args, 0.9, 0.999, 1e-8)
                tc._launch(xs, leaves, run, 512)
    with pytest.raises(ValueError, match="backend"):
        tc.adam_train_realnvp_fused(*args, backend="triton")
    assert launches.counts()["realnvp_train"] == 0


# K6's plan by hand: (model, dtype, batch) -> (CTAs, tiles a CTA at most,
# scratch words, shared-memory bytes a CTA). A lane tile holds the batch in
# whole warps of 32/H rows, at most R rows (R·H = 1,024 threads in float32
# and bfloat16, 512 in float64); min(tiles, 8) CTAs, the first tiles % 8
# one tile more. The shared memory: the lane tile's words
# (`lane_bwd_words`: two padded nets 2·wnet, saved inputs
# 2·n_blocks·rows·d, two nets' activations 2·(rows·(4 + (depth − 1)·H) +
# 4·rows) and cotangents rows·H, with wnet = (4(H+1) + H) + (depth − 2)·
# (H(H+1) + H) + (5H + 4): 456 at H = 16, 1,416 at H = 32), then a term a
# row of a CTA's tiles where that fits in 232,448 bytes. So 912 + 108·rows
# words for the demo (d=2 [16,16]x3, 3,852 weights), 2,832 + 216·rows for
# the reference default ([32,32]x10, 46,120 weights) and 912 + 116·rows
# for d=5 [8,8]x2 (H = 16, 980 weights). The scratch: a weight-gradient
# slice a CTA, a term a row where they do not fit, one word for the
# cluster's size.
PLANS = {
    # 16 rows, 1 tile: 2,640 + 16 terms = 2,656 words
    ("demo", torch.float32, 16): (1, 1, 3852 + 1, 10624),
    # 18 rows (whole warps of 2), 1 tile: 2,856 + 18 = 2,874 words
    ("demo", torch.float32, 17): (1, 1, 3852 + 1, 11496),
    # 32 rows, 8 tiles: 9,744 + 32 = 9,776 words
    ("ref", torch.float32, 256): (8, 1, 8 * 46120 + 1, 39104),
    ("ref", torch.bfloat16, 256): (8, 1, 8 * 46120 + 1, 39104),
    # 16 rows, 16 tiles: 6,288 + 2·16 = 6,320 words
    ("ref", torch.float64, 256): (8, 2, 8 * 46120 + 1, 50560),
    # 9 tiles, the first CTA two: 9,744 + 2·32 = 9,808 words
    ("ref", torch.float32, 257): (8, 2, 8 * 46120 + 1, 39232),
    # 32 tiles: 9,744 + 4·32 = 9,872 words; 64 in float64: 6,288 + 8·16
    ("ref", torch.float32, 1024): (8, 4, 8 * 46120 + 1, 39488),
    ("ref", torch.float64, 1024): (8, 8, 8 * 46120 + 1, 51328),
    # 64 rows and a ragged 36: 8,336 + 64 = 8,400 words
    ("odd", torch.float32, 100): (2, 1, 2 * 980 + 1, 33600),
    # 32 rows, 4 tiles, the last of 4 rows: 4,624 + 32 = 4,656 words
    ("odd", torch.float64, 100): (4, 1, 4 * 980 + 1, 37248),
    # 64 rows, 6,280 tiles, 785 a CTA: 7,824 words + 785·64 terms, 232,256
    # bytes, fit; a row more takes 6,281 tiles, and 786 a CTA do not: the
    # terms go to the scratch
    ("demo", torch.float32, 401920): (8, 785, 8 * 3852 + 1, 232256),
    ("demo", torch.float32, 401921): (8, 786, 8 * 3852 + 401921 + 1,
                                      31296),
    # 32 rows, 8,192 tiles, 1,024 a CTA: 4,368 words; the terms (262,144
    # bytes a CTA) in the scratch
    ("demo", torch.float64, 262144): (8, 1024, 8 * 3852 + 262144 + 1,
                                      34944),
}
MODELS = {"demo": (2, (16, 16), 3), "ref": (2, (32, 32), 10),
          "odd": (5, (8, 8), 2)}


def _plan_flow(model, dtype):
    d, hdims, nlayers = MODELS[model]
    return nft.realnvp(torch.Generator().manual_seed(0), d, hdims,
                       nlayers=nlayers, dtype=dtype, fused=True,
                       device="cpu")


@pytest.mark.parametrize("model,dtype,batch", list(PLANS))
def test_train_plan_matches_hand_counts(model, dtype, batch, k6_lib,
                                        monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: k6_lib)
    d, n_blocks, depth, widths, idx = _c_stack(_plan_flow(model, dtype))
    plan = tc._plan(SFX[dtype], batch, d, n_blocks, depth, widths, idx)
    assert plan == tc.TrainPlan(*PLANS[(model, dtype, batch)])


# the cap the wrapper checks before any step (`_kernel_args`, through
# `coupling_cuda._bwd_tile`) is on the plan's lane tile: the plan's bytes
# are it, or it and a term a row of a CTA's tiles
@pytest.mark.parametrize("model,dtype,batch", list(PLANS))
def test_cap_check_takes_the_plans_lane_tile(model, dtype, batch):
    d, (hidden, _), nlayers = MODELS[model]
    word = cc.word_of(dtype)
    rows, need = cc._bwd_tile(d, nlayers, 3, hidden, word, batch,
                              train=True)
    _, per_cta, _, nbytes = PLANS[(model, dtype, batch)]
    assert nbytes - need in (0, per_cta * rows * word)


# the K6 entries check the scratch and the cluster before they launch
@pytest.mark.parametrize("dtype", list(SFX))
@pytest.mark.parametrize("case,scratch_less,clusters,want", [
    ("scratch", 1, 16, 1), ("cluster", 0, 0, 701),
    ("launch", 0, 16, NOT_EMULATED)])
def test_entry_refuses_before_a_launch(case, scratch_less, clusters, want,
                                       dtype, k6_lib):
    d, n_blocks, depth, widths, idx = _c_stack(_plan_flow("ref", dtype))
    sfx = SFX[dtype]
    plan = (ctypes.c_longlong * 5)()
    assert getattr(k6_lib, f"realnvp_train_plan_{sfx}")(
        d, n_blocks, depth, widths, idx, 256, plan) == 0
    w = torch.zeros(46120, dtype=dtype)
    hyper = (ctypes.c_double * 8)(LR, 0.9, 0.999, 1e-8, 1.0, 100.0, 0.0, 0.0)
    with _clusters(k6_lib, clusters):
        err = getattr(k6_lib, f"realnvp_train_{sfx}")(
            None, w.data_ptr(), None, None, None, plan[2] - scratch_less,
            None, None, None, 50, 0, 256, d, n_blocks, depth, widths, idx, 0,
            hyper, None)
    assert err == want


# the wrapper takes the plan the library answers and allocates its scratch
@pytest.mark.parametrize("model,dtype,batch", [
    ("demo", torch.float32, 16), ("ref", torch.float64, 256),
    ("ref", torch.bfloat16, 256), ("demo", torch.float64, 262144)])
def test_launch_allocates_the_plans_scratch(model, dtype, batch,
                                            monkeypatch):
    sfx = SFX[dtype]
    plan, calls = tc.TrainPlan(*PLANS[(model, dtype, batch)]), []
    xs, leaves, run = _run_of(_plan_flow(model, dtype), batch, 2)
    monkeypatch.setattr(_build, "library",
                        lambda: _fake_library(sfx, plan, calls))
    _cpu_launches(monkeypatch, sfx)
    empty, scratch = torch.empty, []

    def spy_empty(*size, **kw):
        out = empty(*size, **kw)
        scratch.append(out)
        return out

    monkeypatch.setattr(torch, "empty", spy_empty)
    tc._launch(xs, leaves, run, 1)
    grad = scratch[-1]
    assert grad.numel() == plan.scratch_words
    assert grad.dtype == (torch.float32 if dtype == torch.bfloat16
                          else dtype)
    # two launches, each handed that buffer and its size
    assert [(c[4], c[5]) for c in calls] == [
        (grad.data_ptr(), plan.scratch_words)] * 2


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
