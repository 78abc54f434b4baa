"""Port's fused-RQS module (`normalizingflows_torch/ops/rqs_cuda.py`) against
the JAX package's Pallas kernel (interpret mode, as tests/test_rqs_kernel.py
runs it), the JAX and torch oracles, and torch autograd.

On the CPU the wrapper runs the kernels' plain versions; the CUDA kernels
themselves are checked against them on the card by chip_smoke.py.

Tolerances:
* f32 against the Pallas kernel or an oracle: those of
  tests/test_rqs_kernel.py (values rtol/atol 1e-5, log-dets rtol 1e-4 atol
  1e-5; gradients rtol 2e-3 atol 1e-4) — same math, exp/log from different
  libraries and reductions in different orders.
* f64: rtol 1e-9, atol 1e-10 — the same differences at f64 precision
  (about 1e-13 observed); any error in the math shows orders above it.
* plain paths within the port that take the same operations: exact.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from normalizingflows.jl_tpu.ops import rqs as jax_oracle  # noqa: E402
from normalizingflows.jl_tpu.ops import rqs_pallas  # noqa: E402
from normalizingflows_torch.ops import _build  # noqa: E402
from normalizingflows_torch.ops import launches  # noqa: E402
from normalizingflows_torch.ops import rqs as oracle  # noqa: E402
from normalizingflows_torch.ops import rqs_cuda  # noqa: E402

torch.set_num_threads(1)

B = 5.0
N = 200  # not a multiple of any block size
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64,
                                                     torch.float64)}
TOL = {  # (value rtol, value atol, log-det rtol, grad rtol, grad atol)
    "f32": dict(v=(1e-5, 1e-5), ld=(1e-4, 1e-5), g=(2e-3, 1e-4)),
    "f64": dict(v=(1e-9, 1e-10), ld=(1e-9, 1e-10), g=(1e-9, 1e-10)),
}


def _inputs(dt, K, seed=0, n=N):
    """x over [−1.5B, 1.5B] (inside and outside the box; a continuous draw
    lands on ±B or a knot with probability 0) and raw ~ 0.5·N(0, 1), as
    tests/test_rqs_kernel.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5 * B, 1.5 * B, n).astype(DTYPES[dt][0])
    raw = 0.5 * rng.normal(size=(n, 3 * K - 1)).astype(DTYPES[dt][0])
    return x, raw


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol[0],
                               atol=tol[1])


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_plain_tile_matches_pallas_kernel(dt, K, inverse):
    x, raw = _inputs(dt, K, seed=K + inverse)
    y_j, ld_j = jax.jit(lambda x, r: rqs_pallas.rqs_fused(
        x, r, B, inverse=inverse, interpret=True))(jnp.asarray(x),
                                                   jnp.asarray(raw))
    y_t, ld_t = rqs_cuda.tile_transform(_t(x), _t(raw), B, inverse)
    assert y_t.dtype == DTYPES[dt][1]
    _close(y_t, y_j, TOL[dt]["v"])
    _close(ld_t, ld_j, TOL[dt]["ld"])


def _jax_grads(x, raw, inverse=False):
    def loss(x, raw):
        y, ld = rqs_pallas.rqs_fused(x, raw, B, inverse=inverse,
                                     interpret=True)
        return jnp.sum(jnp.sin(y)) + jnp.sum(ld * 0.5)

    return jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x),
                                                   jnp.asarray(raw))


@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_plain_analytic_backward_matches_pallas_grad(dt, K):
    """`tile_bwd_analytic` against `jax.grad` through the Pallas kernel,
    whose VJP is `_tile_bwd_analytic` in interpret mode."""
    x, raw = _inputs(dt, K, seed=3)
    gx_j, graw_j = _jax_grads(x, raw)
    xt, rt = _t(x), _t(raw)
    y, _ = rqs_cuda.tile_transform(xt, rt, B)
    gx, graw = rqs_cuda.tile_bwd_analytic(xt, rt, torch.cos(y),
                                          torch.full_like(y, 0.5), B)
    _close(gx, gx_j, TOL[dt]["g"])
    _close(graw, graw_j, TOL[dt]["g"])


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_plain_tile_matches_oracles(dt, K, inverse):
    """The tile against the port's `ops/rqs.py` oracle, and that oracle
    against the JAX package's."""
    x, raw = _inputs(dt, K, seed=5 + K + inverse)
    xt, rt = _t(x), _t(raw)
    fn = oracle.rqs_inverse if inverse else oracle.rqs_forward
    y_o, ld_o = fn(xt, *oracle.rqs_params_from_raw(rt, B))
    y_t, ld_t = rqs_cuda.tile_transform(xt, rt, B, inverse)
    _close(y_t, y_o, TOL[dt]["v"])
    _close(ld_t, ld_o, TOL[dt]["ld"])

    jfn = jax_oracle.rqs_inverse if inverse else jax_oracle.rqs_forward
    y_j, ld_j = jax.jit(lambda x, r: jfn(
        x, *jax_oracle.rqs_params_from_raw(r, B)))(jnp.asarray(x),
                                                   jnp.asarray(raw))
    _close(y_o, y_j, TOL[dt]["v"])
    _close(ld_o, ld_j, TOL[dt]["ld"])


@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_analytic_backward_matches_autograd(dt, K):
    """The closed-form VJP against torch autograd through the port's own
    plain forward tile."""
    x, raw = _inputs(dt, K, seed=11)
    xt = _t(x).requires_grad_()
    rt = _t(raw).requires_grad_()
    y, ld = rqs_cuda.tile_transform(xt, rt, B)
    gy, gld = torch.cos(y.detach()), torch.full_like(ld, 0.5)
    gx_a, graw_a = torch.autograd.grad((y, ld), (xt, rt), (gy, gld))
    gx, graw = rqs_cuda.tile_bwd_analytic(xt.detach(), rt.detach(), gy, gld,
                                          B)
    _close(gx, gx_a, TOL[dt]["g"])
    _close(graw, graw_a, TOL[dt]["g"])


def _loss_grads(x, raw, fn, use_y=True, use_ld=True):
    x = x.detach().requires_grad_()
    raw = raw.detach().requires_grad_()
    y, ld = fn(x, raw)
    loss = (torch.sin(y).sum() if use_y else 0.0) + (
        (0.5 * ld).sum() if use_ld else 0.0)
    return torch.autograd.grad(loss, (x, raw))


@pytest.mark.parametrize("used", ["y", "ld", "both"])
@pytest.mark.parametrize("inverse", [False, True])
def test_rqs_fused_gradients_match_oracle(inverse, used):
    """`rqs_fused` (autograd.Function, plain backend) against autograd of
    the oracle, with zero cotangents when only y or only ld is used."""
    x, raw = _inputs("f64", 10, seed=13)
    xt, rt = _t(x), _t(raw)
    fn = oracle.rqs_inverse if inverse else oracle.rqs_forward
    kw = dict(use_y=used != "ld", use_ld=used != "y")
    g_o = _loss_grads(xt, rt,
                      lambda x, r: fn(x, *oracle.rqs_params_from_raw(r, B)),
                      **kw)
    g_f = _loss_grads(xt, rt, lambda x, r: rqs_cuda.rqs_fused(
        x, r, B, inverse=inverse, backend="plain"), **kw)
    for a, b in zip(g_f, g_o):
        _close(a, b, TOL["f64"]["g"])


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("inverse", [False, True])
def test_rqs_fused_vjp_is_rqs_fused_backward(inverse, dt):
    """`rqs_fused_vjp` (what the selective remat calls) gives the gradients
    autograd takes through `rqs_fused`, bit for bit, on (2, n) batches of
    x with raw (2, n, 3K−1); it refuses a raw of the wrong shape and a CUDA
    backend on CPU tensors."""
    x, raw = _inputs(dt, 8, seed=19)
    xt, rt = _t(x).reshape(2, -1), _t(raw).reshape(2, N // 2, -1)
    gen = torch.Generator().manual_seed(3)
    gy = torch.randn(xt.shape, generator=gen, dtype=xt.dtype)
    gld = torch.randn(xt.shape, generator=gen, dtype=xt.dtype)
    xg, rg = xt.clone().requires_grad_(), rt.clone().requires_grad_()
    y, ld = rqs_cuda.rqs_fused(xg, rg, B, inverse=inverse)
    want = torch.autograd.grad((y, ld), (xg, rg), (gy, gld))
    got = rqs_cuda.rqs_fused_vjp(xt, rt, gy, gld, B, inverse)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    with pytest.raises(ValueError):
        rqs_cuda.rqs_fused_vjp(xt, rt[..., :-1], gy, gld, B)
    with pytest.raises(ValueError):
        rqs_cuda.rqs_fused_vjp(xt, rt, gy, gld, B, backend="cuda")


def test_outside_box_passes_gradient_through():
    """Outside [−B, B]: y = x, ld = 0, so gx = gy and graw = 0."""
    x, raw = _inputs("f64", 10, seed=17)
    x = np.where(np.abs(x) > B, x, x + np.sign(x) * 2 * B)
    xt, rt = _t(x), _t(raw)
    y, ld = rqs_cuda.tile_transform(xt, rt, B)
    assert torch.equal(y, xt) and torch.count_nonzero(ld) == 0
    gy, gld = torch.randn_like(xt), torch.randn_like(xt)
    gx, graw = rqs_cuda.tile_bwd_analytic(xt, rt, gy, gld, B)
    assert torch.equal(gx, gy) and torch.count_nonzero(graw) == 0


def test_strided_read_elem_and_param_major_agree():
    """raw read elem-major (N, 3K−1), param-major (a (3K−1, N) tensor
    passed as its transposed view), and as the strided (batch·n_t, 3K−1)
    view of a conditioner output give identical values and gradients."""
    K, n_t, batch = 10, 4, 50
    P = 3 * K - 1
    x, raw = _inputs("f64", K, seed=19, n=batch * n_t)
    xt, rt = _t(x), _t(raw)
    g_e = _loss_grads(xt, rt, lambda x, r: rqs_cuda.rqs_fused(x, r, B))
    raw_t = rt.T.contiguous()
    g_t = _loss_grads(xt, raw_t,
                      lambda x, r: rqs_cuda.rqs_fused(x, r.T, B))
    wide = rt.reshape(batch, n_t * P)  # the conditioner's output layout
    g_v = _loss_grads(xt.reshape(batch, n_t), wide,
                      lambda x, r: rqs_cuda.rqs_fused(
                          x, r.reshape(batch, n_t, P), B))
    y_e = rqs_cuda.rqs_fused(xt, rt, B)
    y_t = rqs_cuda.rqs_fused(xt, raw_t.T, B)
    for a, b in zip(y_e, y_t):
        assert torch.equal(a, b)
    assert torch.equal(g_e[0], g_t[0]) and torch.equal(g_e[1], g_t[1].T)
    assert torch.equal(g_e[0], g_v[0].reshape(-1))
    assert torch.equal(g_e[1], g_v[1].reshape(-1, P))


def test_raw_in_another_dtype_gets_its_gradient_in_its_dtype():
    x, raw = _inputs("f64", 8, seed=23)
    xt = _t(x)
    r32 = _t(raw.astype(np.float32)).requires_grad_()
    y, ld = rqs_cuda.rqs_fused(xt, r32, B)
    assert y.dtype == torch.float64
    (g,) = torch.autograd.grad(y.sum() + ld.sum(), (r32,))
    assert g.dtype == torch.float32
    # the f64 computation on the upcast raw, its gradient cast back: exact
    r64 = r32.detach().double().requires_grad_()
    y64, ld64 = rqs_cuda.rqs_fused(xt, r64, B)
    (g_ref,) = torch.autograd.grad(y64.sum() + ld64.sum(), (r64,))
    assert torch.equal(g, g_ref.float())


def test_cpu_tensors_launch_no_kernel(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: the launch
    counters stay at 0 and the kernel library is never built."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "library", no_build)
    launches.reset()
    x, raw = _inputs("f32", 10, seed=29)
    for inverse in (False, True):
        _loss_grads(_t(x), _t(raw), lambda x, r: rqs_cuda.rqs_fused(
            x, r, B, inverse=inverse))
    assert launches.counts() == dict.fromkeys(launches.KERNELS, 0)


@pytest.mark.parametrize("backend,exc", [("cuda", ValueError),
                                         ("pallas", ValueError)])
def test_backend_errors(backend, exc):
    x, raw = _inputs("f32", 10)
    with pytest.raises(exc):
        rqs_cuda.rqs_fused(_t(x), _t(raw), B, backend=backend)


def test_bad_raw_shape_raises():
    x, raw = _inputs("f32", 10)
    with pytest.raises(ValueError):
        rqs_cuda.rqs_fused(_t(x), _t(raw[:, :-1]), B)
    with pytest.raises(ValueError):
        rqs_cuda.rqs_fused(_t(x[:-1]), _t(raw), B)


def test_ctypes_argtypes_match_the_c_entries():
    """Each extern "C" entry of csrc/*.cu (rqs.cu, rqs_bf16.cu,
    coupling.cu, ...) is bound, with one argtype per C parameter; rqs.cu
    and rqs_bf16.cu are built without contraction."""
    sigs = {}
    for path in _build._sources():
        if path.suffix == ".cu":
            src = path.read_text()
            block = src[src.index('extern "C" {'):]
            sigs.update(re.findall(r"int (\w+)\(([^)]*)\)", block))
    assert set(sigs) == set(_build.ENTRIES)
    for name, params in sigs.items():
        assert len(params.split(",")) == len(_build.ENTRIES[name]), name
    # K1 takes its plan, staged and the shared row stride, between raw's
    # strides and K
    P_, I64, I32, F64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_double)
    for sfx in ("f32", "f64", "f32_rbf16", "bf16"):
        assert _build.ENTRIES[f"rqs_fwd_{sfx}"] == [
            P_, P_, P_, P_, I64, I64, I64, I32, I32, I32, F64, I32, P_]
    for name in ("rqs.cu", "rqs_bf16.cu", "coupling.cu"):
        assert Path(_build.CSRC, name) in _build._sources()
    assert "--fmad=false" in _build.SOURCE_FLAGS["rqs.cu"]
    assert "--fmad=false" in _build.SOURCE_FLAGS["rqs_bf16.cu"]
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# K2/K3's launch plan (`bwd_plan`) and what `_launch_bwd` hands the C entry

WORD = {"f32": 4, "f64": 8}


@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_bwd_plan_stages_elem_major_raw(dt, K, pad):
    """Elem-major raw (the conditioner's (N, 3K−1) view, or padded to
    3K+2 columns) goes through the staged tile: 256 rows a CTA, an odd
    shared row stride at least graw's columns (no bank conflicts), and the
    bytes a block may use."""
    gcols = 3 * K - 1 + pad
    plan = rqs_cuda.bwd_plan(gcols, gcols, K, WORD[dt])
    assert plan.staged and plan.rows == rqs_cuda.BWD_ROWS == 256
    assert plan.stride % 2 == 1 and gcols <= plan.stride <= gcols + 1
    assert plan.bytes == plan.rows * plan.stride * WORD[dt]
    assert plan.bytes <= rqs_cuda.KERNEL_MAX_SMEM == 227 * 1024


@pytest.mark.parametrize("dt,widest", [("f32", 227), ("f64", 113)])
def test_bwd_plan_refuses_rows_past_the_shared_memory_cap(dt, widest):
    """The widest graw row that fits 227 KB is planned; one column more
    raises a ValueError that names the cap, before any launch."""
    plan = rqs_cuda.bwd_plan(widest, widest, 10, WORD[dt])
    assert plan.staged and plan.bytes <= rqs_cuda.KERNEL_MAX_SMEM
    with pytest.raises(ValueError, match=f"at most {widest} columns"):
        rqs_cuda.bwd_plan(widest + 1, widest + 1, 10, WORD[dt])


@pytest.mark.parametrize("K", [8, 10])
def test_bwd_plan_reads_param_major_raw_directly(K):
    """Param-major raw (stride 1 between elements) is coalesced as it is:
    the direct read, no shared memory, at either word size."""
    for word in (4, 8):
        assert rqs_cuda.bwd_plan(1, 3 * K - 1, K, word) == \
            rqs_cuda.BwdPlan(False, 256, 0, 0)


def test_bwd_rows_match_the_kernel():
    """The plan's rows are the kernels' CTA (kThreads in
    csrc/rqs_device.cuh)."""
    src = Path(_build.CSRC, "rqs_device.cuh").read_text()
    threads = re.search(r"constexpr int kThreads = (\d+);", src).group(1)
    assert int(threads) == rqs_cuda.BWD_ROWS


# K1's launch plan (`fwd_plan`) and what `_launch_fwd` hands the C entry

@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_fwd_plan_stages_elem_major_raw(dt, K, pad):
    """Elem-major raw (the conditioner's (N, 3K−1) view, or padded to 3K+2
    columns) goes through the staged tile: an odd shared row stride of
    3K−1 (29 at K=10, 23 at K=8: no bank conflicts), one tile of BWD_ROWS
    rows, within the bytes a block may use."""
    plan = rqs_cuda.fwd_plan(3 * K - 1 + pad, K, WORD[dt])
    assert plan.staged
    assert plan.stride % 2 == 1 and plan.stride == 3 * K - 1
    assert plan.bytes == rqs_cuda.BWD_ROWS * plan.stride * WORD[dt]
    assert plan.bytes <= rqs_cuda.KERNEL_MAX_SMEM


@pytest.mark.parametrize("stride_elem", [2, 64, 1000])
def test_fwd_plan_stages_any_row_stride(stride_elem):
    """A row stride other than 3K−1 or its padding (a strided view) is
    staged too: the tile copies raw's 3K−1 columns whatever its stride."""
    plan = rqs_cuda.fwd_plan(stride_elem, 10, 4)
    assert plan == rqs_cuda.FwdPlan(True, 29, 256 * 29 * 4)


@pytest.mark.parametrize("K", [8, 10])
def test_fwd_plan_reads_param_major_raw_directly(K):
    """Param-major raw (stride 1 between elements) is coalesced as it is:
    the direct read, no shared memory, at either word size."""
    for word in (4, 8):
        assert rqs_cuda.fwd_plan(1, K, word) == rqs_cuda.FwdPlan(False, 0, 0)


@pytest.mark.parametrize("dt,widest", [("f32", 76), ("f64", 38)])
def test_fwd_plan_refuses_a_row_past_the_shared_memory_cap(dt, widest):
    """The widest row whose 256-row tile fits 227 KB (K=76: 227 words in
    f32; K=38: 113 in f64) is planned; the next K raises a ValueError that
    names the cap, before any launch."""
    plan = rqs_cuda.fwd_plan(3 * widest - 1, widest, WORD[dt])
    assert plan.staged and plan.bytes <= rqs_cuda.KERNEL_MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        rqs_cuda.fwd_plan(3 * widest + 2, widest + 1, WORD[dt])


def test_fwd_plan_is_one_the_kernel_takes():
    """K1's tile is one CTA of kThreads rows, as K2/K3's (BWD_ROWS), and
    the C launch refuses a staged stride that is even or short of 3K−1,
    as `fwd_plan` never gives."""
    src = Path(_build.CSRC, "rqs_device.cuh").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);",
                            src).group(1))
    assert rqs_cuda.BWD_ROWS == threads
    assert ("if (staged && (stride < 3 * K - 1 || stride % 2 == 0))"
            in src)
    for K in (8, 10):
        for word in (4, 8):
            s = rqs_cuda.fwd_plan(3 * K - 1, K, word).stride
            assert s % 2 == 1 and s >= 3 * K - 1


def _fake_entries(monkeypatch):
    """The C entries replaced by one that records its arguments; the
    device and stream calls made harmless for CPU tensors."""
    import contextlib
    import types

    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name,) + args)
            return 0
        return fn

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(**{
        f"{k}_{s}": entry(f"{k}_{s}") for k in ("rqs_fwd", "rqs_bwd_fwddir",
                                                "rqs_bwd_invdir")
        for s in ("f32", "f64")}))
    # the device checks want CUDA tensors (test_backend_errors covers them)
    monkeypatch.setattr(rqs_cuda, "_kernel_args",
                        lambda x, raw, K:
                        rqs_cuda.KERNEL_TYPES[(x.dtype, raw.dtype)])
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    launches.reset()
    return calls


def _raw_layout(layout, n, P):
    return {"dense": lambda: torch.zeros(n, P),
            "conditioner": lambda: torch.zeros(n // 32, 32 * P).view(n, P),
            "padded": lambda: torch.zeros(n, P + 3),
            "param-major": lambda: torch.zeros(P, n).T}[layout]()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("layout,staged", [
    ("dense", True), ("conditioner", True), ("padded", True),
    ("param-major", False)])
def test_launch_fwd_hands_the_entry_its_plan(layout, staged, inverse,
                                             monkeypatch):
    """For each layout of raw, K1's entry gets raw's strides and the plan:
    the staged tile (shared row stride 29) for elem-major raw (dense, the
    conditioner's (batch, n_t·(3K−1)) output viewed per element, padded to
    3K+2), the direct read for param-major; one launch counted."""
    calls = _fake_entries(monkeypatch)
    K, n, P = 10, 96, 29
    x = torch.zeros(n, dtype=torch.float32)
    raw = _raw_layout(layout, n, P)
    y, ld = rqs_cuda._launch_fwd(x, raw, B, K, inverse)
    (name, xp, rp, yp, ldp, n_, se, sp, st, s, k, b, inv, stream), = calls
    assert name == "rqs_fwd_f32"
    assert (xp, rp, yp, ldp) == (x.data_ptr(), raw.data_ptr(), y.data_ptr(),
                                 ld.data_ptr())
    assert (n_, se, sp) == (n, *raw.stride())
    assert (st, s) == ((1, 29) if staged else (0, 0))
    assert (k, b, inv, stream) == (K, B, int(inverse), 0)
    assert launches.counts() == {**dict.fromkeys(launches.KERNELS, 0),
                                 "rqs_fwd": 1}


def test_launch_fwd_refuses_a_bad_plan_before_launching(monkeypatch):
    """A staged tile too large for a block's shared memory raises before
    the entry is called, and counts no launch."""
    calls = _fake_entries(monkeypatch)
    monkeypatch.setattr(rqs_cuda, "BWD_ROWS", 4096)
    x = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        rqs_cuda._launch_fwd(x, torch.zeros(8, 29, dtype=torch.float64), B,
                             10, False)
    assert calls == [] and launches.counts()["rqs_fwd"] == 0


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("layout,staged,stride", [
    ("dense", True, 29), ("conditioner", True, 29), ("padded", True, 33),
    ("param-major", False, 0)])
def test_launch_bwd_hands_the_entry_its_plan(layout, staged, stride, inverse,
                                             monkeypatch):
    """For each layout of raw, the entry gets raw's and graw's strides,
    graw's columns and the plan: staged with the odd stride for elem-major
    raw (dense, the conditioner's (batch, n_t·(3K−1)) output viewed per
    element, padded to 3K+2), direct for param-major."""
    calls = _fake_entries(monkeypatch)
    K, n, P = 10, 96, 29
    x = torch.zeros(n, dtype=torch.float32)
    raw = {"dense": lambda: torch.zeros(n, P),
           "conditioner": lambda: torch.zeros(n // 32, 32 * P).view(n, P),
           "padded": lambda: torch.zeros(n, P + 3),
           "param-major": lambda: torch.zeros(P, n).T}[layout]()
    gx, graw = rqs_cuda._launch_bwd(x, raw, x, x, B, K, inverse)
    assert graw.stride() == raw.stride() and graw.shape == raw.shape
    (name, xp, rp, gyp, gldp, gxp, grp, n_, se, sp, gse, gsp, gcols, st,
     rows, s, k, b, stream), = calls
    assert name == ("rqs_bwd_invdir_f32" if inverse else "rqs_bwd_fwddir_f32")
    assert (xp, rp, gxp, grp) == (x.data_ptr(), raw.data_ptr(),
                                  gx.data_ptr(), graw.data_ptr())
    assert (n_, se, sp, gse, gsp, gcols) == (n, *raw.stride(),
                                            *graw.stride(), raw.shape[1])
    assert (st, rows, s, k, b, stream) == (int(staged), 256, stride, K, B, 0)
    kernel = "rqs_bwd_invdir" if inverse else "rqs_bwd_fwddir"
    assert launches.counts() == {**dict.fromkeys(launches.KERNELS, 0),
                                 kernel: 1}


def test_launch_bwd_refuses_a_row_past_the_cap_before_launching(monkeypatch):
    """A padded raw too wide for the staged tile raises before the entry
    is called, and counts no launch."""
    calls = _fake_entries(monkeypatch)
    x = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        rqs_cuda._launch_bwd(x, torch.zeros(8, 200, dtype=torch.float64),
                             x, x, B, 10, False)
    assert calls == [] and launches.counts()["rqs_bwd_fwddir"] == 0


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_114rqs_bwd_fwddirIfLi10ELb1EEEvNS_7BwdArgsIT_EE",
     "rqs_bwd_fwddir<f32, K=10, staged>"),
    ("_ZN12_GLOBAL__N_114rqs_bwd_invdirIdLi8ELb0EEEvNS_7BwdArgsIT_EE",
     "rqs_bwd_invdir<f64, K=8, direct>"),
    ("_ZN12_GLOBAL__N_17rqs_fwdIfLi10ELb1EEEvPKT_S3_PS1_S4_llld",
     "rqs_fwd<f32, K=10, inv>"),
    ("_ZN12_GLOBAL__N_17rqs_fwdIfLi10ELb0ELb1EEEvNS_7FwdArgsIT_EE",
     "rqs_fwd<f32, K=10, fwd, staged>"),
    ("_ZN12_GLOBAL__N_17rqs_fwdIdLi8ELb1ELb0EEEvNS_7FwdArgsIT_EE",
     "rqs_fwd<f64, K=8, inv, direct>"),
    # the kernels' (x, raw) type pair, and the bfloat16 instantiations
    ("_ZN12_GLOBAL__N_17rqs_fwdIffLi10ELb0ELb1EEEvNS_7FwdArgsIT_T0_EE",
     "rqs_fwd<f32, K=10, fwd, staged>"),
    ("_ZN12_GLOBAL__N_17rqs_fwdIf13__nv_bfloat16Li10ELb1ELb1EEEvNS_7FwdArgs"
     "IT_T0_EE", "rqs_fwd<f32_rbf16, K=10, inv, staged>"),
    ("_ZN12_GLOBAL__N_114rqs_bwd_fwddirI13__nv_bfloat16S1_Li8ELb0EEEvNS_7"
     "BwdArgsIT_T0_EE", "rqs_bwd_fwddir<bf16, K=8, direct>"),
    ("_ZN12_GLOBAL__N_112coupling_fwdIfLb1ELi16ENS_12Bf16OperandsEEEvPKNT2_"
     "1SEPS3_S6_lNS_5StackE", "coupling_fwd<f32_cbf16, inv, H=16>"),
    ("_ZN12_GLOBAL__N_112coupling_bwdIfLb0ELi32ENS_11Bf16StorageEEEvPKNT2_"
     "1SE", "coupling_bwd<bf16, fwd, H=32>"),
    # the bf16 policy's tensor-core kernels: INVERSE and H, no type
    ("_ZN12_GLOBAL__N_116coupling_fwd_mmaILb1ELi16EEEvPKfPfS3_l5Stack"
     "9MmaLayout", "coupling_fwd_mma<f32_cbf16, inv, H=16>"),
    ("_ZN12_GLOBAL__N_116coupling_bwd_mmaILb0ELi32EEEvPKfS3_S3_PfS4_ll5Stack"
     "9MmaLayout", "coupling_bwd_mma<f32_cbf16, fwd, H=32>"),
    # ... and their float64 redesign's names
    ("_ZN12_GLOBAL__N_117coupling_fwd_dmmaILb1ELi16EEEvPKfPfS3_l5Stack"
     "9MmaLayout", "coupling_fwd_dmma<f32_cbf16, inv, H=16>"),
    ("_ZN12_GLOBAL__N_117coupling_bwd_dmmaILb0ELi32EEEvPKfS3_S3_PfS4_ll5Stack"
     "9MmaLayout", "coupling_bwd_dmma<f32_cbf16, fwd, H=32>"),
    ("_ZN12_GLOBAL__N_118coupling_fwd_lanesIdLb0ELi16ENS_5ExactIdEEEEvPKNT2_"
     "1SE", "coupling_fwd_lanes<f64, fwd, H=16>"),
    ("_ZN12_GLOBAL__N_119coupling_bwd_reduceIf13__nv_bfloat16EEvPKT_ilNS_"
     "9GradTableE", "coupling_bwd_reduce<bf16>"),
    # K6 on its storage policy
    ("_ZN12_GLOBAL__N_113realnvp_trainIfLi16ENS_5ExactIfEEEEvPKNT1_1SEPS3_"
     "S6_S6_PT_S6_S5_S5_illlNS_5TrainIS7_EENS_5StackE",
     "realnvp_train<f32, H=16>"),
    ("_ZN12_GLOBAL__N_113realnvp_trainIdLi32ENS_5ExactIdEEEEvPKNT1_1SE",
     "realnvp_train<f64, H=32>"),
    ("_ZN12_GLOBAL__N_113realnvp_trainIfLi32ENS_11Bf16StorageEEEvPKNT1_1SE",
     "realnvp_train<bf16, H=32>"),
])
def test_chip_smoke_names_rqs_kernels_in_the_ptxas_report(mangled, name):
    """chip_smoke.py's register report reads K2/K3's bool as STAGED and
    K1's as INVERSE, then STAGED, with registers and spill bytes."""
    cs = _chip_smoke()
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           f"'sm_90a'\n    0 bytes stack frame, 8 bytes spill stores, 4 "
           f"bytes spill loads\nptxas info    : Used 80 registers, used 1 "
           f"barriers\n")
    assert cs.ptxas_report(log) == [(name, 80, 8, 4)]


def test_build_reads_its_log_back(tmp_path, monkeypatch):
    """A library built by an earlier call gives the log of its build
    (ptxas's register report), not an empty one: here with a stand-in for
    nvcc that writes its output and reports each source."""
    import sys

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\nimport sys\nargs = sys.argv[1:]\n"
        "open(args[args.index('-o') + 1], 'w').write('')\n"
        "if '-c' in args:\n"
        "    print('ptxas info    : Used 63 registers, ' + args[-1])\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first, again = _build.build(), _build.build()
    assert first.log.count("Used 63 registers") == len(
        list(_build.CSRC.glob("*.cu")))
    assert (again.path, again.log, again.seconds) == (first.path, first.log,
                                                       0.0)


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_counts_k1_sass_statically():
    """K1's static issue estimate counts the SASS instructions of its
    float32 K=10 forward staged function as cuobjdump -sass prints them,
    each once: from the function's start to its last EXIT, predicated ones
    too, NOPs and encodings not; the slow-path subroutines after the last
    EXIT apart, and no instruction of another function."""
    cs = _chip_smoke()
    sass = """
\t\tFunction : _ZN12_GLOBAL__N_17rqs_fwdIffLi8ELb0ELb1EEEvNS_7FwdArgsIT_T0_EE
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x0 */
        /*0010*/                   EXIT ;                          /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_17rqs_fwdIffLi10ELb0ELb1EEEvNS_7FwdArgsIT_T0_EE
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x0 */
                                                                   /* 0x0 */
        /*0010*/                   S2R R0, SR_TID.X ;              /* 0x0 */
        /*0020*/                   LDGSTS.E [R9], desc[UR10][R6.64] ;
        /*0030*/               @P1 BRA 0x20 ;                      /* 0x0 */
        /*0040*/                   NOP ;                           /* 0x0 */
        /*0050*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;   /* 0x0 */
        /*0060*/              @!P0 EXIT ;                          /* 0x0 */
        /*0070*/                   FADD R2, R2, R0 ;               /* 0x0 */
        /*0080*/                   CALL.REL.NOINC 0xc0 ;           /* 0x0 */
        /*0090*/                   EXIT ;                          /* 0x0 */
        /*00a0*/                   MUFU.RCP R3, R2 ;               /* 0x0 */
        /*00b0*/                   @P2 BRA 0xa0 ;                  /* 0x0 */
        /*00c0*/                   RET.REL.NODEC R4 0x0 ;          /* 0x0 */
        /*00d0*/                   BRA 0xd0;                       /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_17rqs_fwdIffLi10ELb1ELb1EEEvNS_7FwdArgsIT_T0_EE
        /*0000*/                   EXIT ;                          /* 0x0 */
"""
    assert cs.sass_counts(sass, cs.K1_SASS) == (13, 9)
    assert cs.sass_counts(sass, "no_such_kernel") is None


def test_chip_smoke_counts_the_policy_kernels_hmma():
    """Phase 2's evidence that the bf16 policy's products run on the tensor
    cores: each HMMA instruction (predicated ones too) of each named
    kernel, by its phase-2 name, each once; a kernel without one counts 0."""
    cs = _chip_smoke()
    sass = """
\t\tFunction : _ZN12_GLOBAL__N_116coupling_fwd_mmaILb1ELi16EEEvPKfPfS3_l5Stack9MmaLayout
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x0 */
        /*0010*/                   HMMA.16816.F32.BF16 R8, R4, R16, RZ ;
        /*0020*/              @!P0 HMMA.16816.F32.BF16 R8, R4, R18, R8 ;
        /*0030*/                   EXIT ;                          /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_116coupling_bwd_mmaILb0ELi32EEEvPKfS3_S3_PfS4_ll5Stack9MmaLayout
        /*0000*/                   FFMA R2, R2, R0, R1 ;           /* 0x0 */
\t\tFunction : some_other_function
        /*0000*/                   HMMA.16816.F32.BF16 R8, R4, R16, RZ ;
"""
    assert cs.hmma_counts(sass) == {
        "coupling_fwd_mma<f32_cbf16, inv, H=16>": 2,
        "coupling_bwd_mma<f32_cbf16, fwd, H=32>": 0}


def test_chip_smoke_counts_the_policy_kernels_dmma():
    """Phase 2's evidence that the redesigned policy kernels take their
    exact sums on the float64 tensor cores: the DMMA instructions (both
    shapes, predicated ones too) and, apart, the HMMA ones of each of the
    renamed kernels."""
    cs = _chip_smoke()
    sass = """
\t\tFunction : _ZN12_GLOBAL__N_117coupling_fwd_dmmaILb1ELi16EEEvPKfPfS3_l5Stack9MmaLayout
        /*0000*/                   DMMA.16x8x4 R8, R4, R16, RZ ;
        /*0010*/              @!P0 DMMA.16x8x16 R8, R4, R18, R8 ;
        /*0020*/                   EXIT ;                          /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_117coupling_bwd_dmmaILb0ELi32EEEvPKfS3_S3_PfS4_ll5Stack9MmaLayout
        /*0000*/                   DMMA.16x8x16 R8, R4, R18, R8 ;
        /*0010*/                   HMMA.16816.F32.BF16 R8, R4, R16, RZ ;
        /*0020*/                   DFMA R2, R2, R0, R1 ;           /* 0x0 */
"""
    assert cs.hmma_counts(sass, "DMMA") == {
        "coupling_fwd_dmma<f32_cbf16, inv, H=16>": 2,
        "coupling_bwd_dmma<f32_cbf16, fwd, H=32>": 1}
    assert cs.hmma_counts(sass) == {
        "coupling_fwd_dmma<f32_cbf16, inv, H=16>": 0,
        "coupling_bwd_dmma<f32_cbf16, fwd, H=32>": 1}
