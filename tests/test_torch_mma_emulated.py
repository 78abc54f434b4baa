"""The bf16 policy's tensor-core K4/K5 (csrc/coupling_mma.cuh) run on the
CPU through a host emulation of the warp primitives they use
(tests/mma_emulation.h: each CUDA thread a std::thread, ldmatrix and
mma.sync by the PTX ISA's fragment layouts), against their plain versions
`tile_flow` / `tile_flow_bwd` under the policy.

The kernels' sources are compiled as they are, with g++, after three
mechanical rewrites: a launch ``k<<<grid, threads, smem, stream>>>(...)``
becomes ``emu_launch(k, grid, threads, smem, stream, ...)``, the inline-PTX
fragment helpers give way to the emulation's, and cp.async copies at once.
The shared-memory cap and the warps a CTA are variables here, so that a
stack that would be staged whole can be staged a coupling at a time, and
a row can be run at each CTA size the kernels are built for. The
policy's plan (`coupling_cuda.mma_plan`, the C entry `coupling_mma_plan`)
is asked of the same library.

Tolerances: the emulated tensor core truncates its exact sum to float32
and the kernel moves it back half an ulp (`unbias`); cuBLAS (the plain
version) sums in float32 in another order. So values agree to float32
roundoff (rtol/atol 1e-4 on y, ld and gx · N; measured at most 1.5e-5),
and a bfloat16 rounding downstream can flip, moving a term of a weight
gradient by 2^-8 of its scale: each gradient within 1e-3 relative L2 (a
few flips among 40 rows; measured at most 3.7e-5). A fault of the
fragments' layout moves them by their own size.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import normalizingflows_torch as nft
from normalizingflows_torch.experimental import coupling_cuda as cc
from normalizingflows_torch.ops import _build

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BF = torch.bfloat16
VALUE_TOL = (1e-4, 1e-4)   # rtol, atol of y, ld and gx · N
LEAF_REL = 1e-3            # relative L2 error of each weight gradient
# (d, hidden widths, blocks): the demo's H = 16; H = 32 (two k16 chunks a
# layer); d = 8 with 4 layers (n_A = n_B = 4, the head's whole n8 tile);
# d = 5 (n_A 3 and 2)
SHAPES = {"demo": (2, (16, 16), 3), "h32": (2, (32, 32), 2),
          "d8": (8, (32, 32, 32), 1), "d5": (5, (8, 8), 2)}
DEMO_WIDTHS = [1, 16, 16, 1] * 2  # the C interface's, per group n_B ... n_A
HELPERS = ("smem_at", "pack2", "lo_of", "hi_of", "ldsm_x2", "ldsm_x4",
           "ldsm_x2_t", "ldsm_x4_t", "mma16816")
CP_ASYNC = """#pragma once
namespace {
template <typename T>
inline void cp_word(T* dst, const T* src, bool valid = true) {
  *dst = valid ? *src : T(0);
}
inline void cp_chunk(void* dst, const void* src) { memcpy(dst, src, 16); }
inline void cp_commit() {}
inline void cp_wait_all() {}
inline void cp_wait_one() {}
}  // namespace
"""
MAIN = """#include "mma_emulation.h"
thread_local dim3s threadIdx, blockIdx;
dim3s blockDim, gridDim;
__attribute__((aligned(16))) unsigned char coupling_smem[kEmuSmem];
Barrier g_block_bar;
Warp g_warps[8];
#include "coupling_bf16.cu"
extern "C" void emu_set_cap(int bytes) { kMmaMaxSmem = bytes; }
extern "C" void emu_set_warps(int w) { kMmaWarps = w; }
"""


def _rewrite(text: str, name: str) -> str:
    text = re.sub(r"(\w+(?:<[^;{}]*?>)?)<<<(.*?)>>>\(",
                  r"emu_launch(\1, \2, ", text, flags=re.S)
    text = re.sub(r"#include <cuda_(bf16|runtime)\.h>\n", "", text)
    if name == "coupling_mma.cuh":
        for fn in HELPERS:
            text, k = re.subn(
                rf"__device__ __forceinline__ \w+ {fn}\(.*?\n\}}\n", "",
                text, flags=re.S)
            assert k == 1, fn
        for name in ("kMmaMaxSmem", "kMmaWarps"):
            text, k = re.subn(rf"constexpr int {name} = ",
                              f"int {name} = ", text)
            assert k == 1, name
        text, k = re.subn(r"static_assert\(kMmaWarps.*?\);\n", "", text)
        assert k == 1
    return text


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The emulated kernels' library, built with g++ from csrc/."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation")
    out = tmp_path_factory.mktemp("mma_emulation")
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (out / src.name).write_text(
                CP_ASYNC if src.name == "cp_async.cuh"
                else _rewrite(src.read_text(), src.name))
    shutil.copy(ROOT / "tests" / "mma_emulation.h", out)
    (out / "main.cpp").write_text(MAIN)
    lib = out / "libmma_emulated.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread",
                    "-Wno-unknown-pragmas", "-I", str(out), "-o", str(lib),
                    str(out / "main.cpp")], check=True, capture_output=True,
                   timeout=600)
    lib = ctypes.CDLL(str(lib))
    for name in ("coupling_fwd_f32_cbf16", "coupling_bwd_f32_cbf16",
                 "coupling_mma_plan"):
        getattr(lib, name).argtypes = _build.ENTRIES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.emu_set_cap.argtypes = [ctypes.c_int]
    lib.emu_set_warps.argtypes = [ctypes.c_int]
    yield lib


@pytest.fixture
def planned(emu, monkeypatch):
    """`coupling_cuda.mma_plan` answered by the emulated library."""
    monkeypatch.setattr(_build, "library", lambda: emu)
    return emu


@contextlib.contextmanager
def _warps(emu, w):
    """K4 and K5 at w warps a CTA, then the build's 4 again."""
    emu.emu_set_warps(w)
    try:
        yield
    finally:
        emu.emu_set_warps(4)


def _stack(shape, seed=0):
    """A perturbed fused RealNVP under the policy, its selections, leaves
    and the C interface's int arrays."""
    d, hdims, blocks = SHAPES[shape]
    g = torch.Generator().manual_seed(seed)
    flow = nft.realnvp(g, d, hdims, nlayers=blocks, fused=True,
                       compute_dtype=BF, device="cpu")
    fb = flow.bijector.bijectors[0]
    with torch.no_grad():
        for p in fb.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    sels = cc._sels(fb.idx_even, fb.idx_odd, d)
    leaves = [t.detach().contiguous() for t in cc._leaves(fb.groups)]
    widths = []
    for grp in ("even", "odd"):
        widths += [fb.groups[grp]["s"][0][0].shape[1]] + [
            W.shape[2] for W, _ in fb.groups[grp]["s"]]
    c_int = ctypes.c_int
    args = ((c_int * len(widths))(*widths),
            (c_int * (2 * d))(*(sum(sels, ()))))
    return fb, sels, leaves, args


def _inputs(d, n, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
            / n,
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)) / n)


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _run(emu, stack, x, gy, gld, inverse, warps=4, k5=True):
    """K4 (and K5) at ``warps`` warps a CTA through the C entries: (y, ld,
    gx, weight grads)."""
    with _warps(emu, warps):
        return _entries(emu, stack, x, gy, gld, inverse, warps, k5)


def _entries(emu, stack, x, gy, gld, inverse, warps, k5):
    _, _, leaves, (widths, idx) = stack
    n, d = x.shape
    blocks, depth = leaves[0].shape[0], len(leaves) // 8
    y, ld = torch.full_like(x, np.nan), torch.full((n,), np.nan)
    assert emu.coupling_fwd_f32_cbf16(
        x.data_ptr(), y.data_ptr(), ld.data_ptr(), n, d, blocks, depth,
        widths, idx, _ptrs(leaves), 0, int(inverse), None) == 0
    if not k5:
        return y, ld
    n_ctas = -(-n // (16 * warps))
    gx = torch.full_like(x, np.nan)
    grads = [torch.full_like(t, np.nan) for t in leaves]
    scratch = torch.empty(n_ctas * sum(t.numel() for t in leaves))
    assert emu.coupling_bwd_f32_cbf16(
        x.data_ptr(), gy.data_ptr(), gld.data_ptr(), gx.data_ptr(),
        scratch.data_ptr(), n, d, blocks, depth, widths, idx, _ptrs(leaves),
        _ptrs(grads), n_ctas, int(inverse), None) == 0
    return y, ld, gx, grads


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulated_policy_kernels_match_their_plain_versions(emu, shape,
                                                            inverse):
    """y, ld, gx and every weight gradient at 40 rows (two CTAs of 32
    rows, the second ragged), forward and inverse."""
    stack = _stack(shape)
    fb, sels = stack[0], stack[1]
    x, gy, gld = _inputs(SHAPES[shape][0], 40)
    y, ld, gx, grads = _run(emu, stack, x, gy, gld, inverse, 2)
    y_p, ld_p = cc.tile_flow(x, fb.groups, sels, inverse, BF)
    gx_p, tree = cc.tile_flow_bwd(x, fb.groups, gy, gld, sels, inverse, BF)
    for a, b in ((y, y_p), (ld, ld_p), (gx * 40, gx_p * 40)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(),
                                   rtol=VALUE_TOL[0], atol=VALUE_TOL[1])
    for i, (a, b) in enumerate(zip(grads, cc._leaves(tree))):
        assert _rel(a, b) <= LEAF_REL, (i, _rel(a, b))


@pytest.mark.parametrize("inverse", [False, True])
def test_emulated_policy_rows_keep_their_bits(emu, inverse):
    """A row's y, ld and gx do not depend on where it lands: at 1, 2, 4
    and 8 warps a CTA, with CTAs that walk several tiles (K4's grid is
    the emulation's 3 SMs), and split at a 16-row boundary into two
    launches, the bits of one launch at 4 warps; two runs agree in every
    output, the weight gradients too."""
    stack = _stack("demo")
    x, gy, gld = _inputs(2, 300)
    want = _run(emu, stack, x, gy, gld, inverse)
    again = _run(emu, stack, x, gy, gld, inverse)
    for a, b in zip(want[:3] + tuple(want[3]), again[:3] + tuple(again[3])):
        assert torch.equal(a, b)
    for warps in (1, 2, 8):
        got = _run(emu, stack, x, gy, gld, inverse, warps)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b), warps
    parts = [_run(emu, stack, x[a:b].contiguous(), gy[a:b].contiguous(),
                  gld[a:b].contiguous(), inverse)
             for a, b in ((0, 144), (144, 300))]
    for i in range(3):
        assert torch.equal(torch.cat([p[i] for p in parts]), want[i])


@pytest.mark.parametrize("inverse", [False, True])
def test_emulated_policy_one_slot_gives_the_resident_bits(planned,
                                                          inverse):
    """Under a smaller shared-memory cap the demo's stack is staged a
    coupling at a time, and K5's partial sums go to device memory (K5
    under 40,000 bytes: resident it needs 53,184 and 68,592 with its
    partial sums, with one slot 37,504; K4 under 20,000: 41,280 against
    12,160), and every output keeps its bits."""
    emu = planned
    stack = _stack("demo")
    x, gy, gld = _inputs(2, 100)
    want = _run(emu, stack, x, gy, gld, inverse)
    assert cc.mma_plan(2, 3, 3, DEMO_WIDTHS, True) == (64, 68592)
    assert cc.mma_plan(2, 3, 3, DEMO_WIDTHS) == (64, 41280)
    try:
        emu.emu_set_cap(40000)
        got = _run(emu, stack, x, gy, gld, inverse)
        emu.emu_set_cap(20000)
        y, ld = _run(emu, stack, x, gy, gld, inverse, k5=False)
    finally:
        emu.emu_set_cap(227 * 1024)
    for a, b in zip(got[:3] + tuple(got[3]), want[:3] + tuple(want[3])):
        assert torch.equal(a, b)
    assert torch.equal(y, want[0]) and torch.equal(ld, want[1])


def _widths(d, depth, hidden):
    """The C interface's widths: per group n_B, the hidden widths, n_A."""
    return [d - d // 2, *([hidden] * (depth - 1)), d // 2] * 2


# (d, blocks, depth, hidden, K5?, rows, bytes) of the bf16 policy's
# tensor-core K4/K5 (`mma_plan`) at 4 warps a CTA, 64 rows. One net
# staged: layer 0's Wᵀ H×8 bfloat16, each hidden layer's H×(H+8), the
# head's 8×(H+8), then (depth−1)·H + 8 float32 biases: 2·(128 + 384 +
# 192) + 4·40 = 1,568 bytes at H=16, depth 3; 2·(256 + 1,280 + 320) + 4·72
# = 4,000 at H=32; 2·(256 + 2·1,280 + 320) + 4·104 = 6,688 at H=32, depth
# 4. A coupling is two nets; every coupling is staged where the whole fits
# in 227 KB, else one. Then each warp's x rows, 64 rows of 9 words (2,304
# bytes); K5 also the cotangent rows (2,304), every coupling's input
# (2·blocks·64·d words), the kept x_B (64 rows of 16 bytes), each net's
# hidden levels (2·(depth−1)·64·(H+8)·2 bytes) and two layers' G
# (2·64·(H+8)·2) and bias partials (2·4·H words); then landing slots of a
# coupling's float32 words at the bounds, 2·(4H + H + (depth−2)(H² + H) +
# 4H + 4) words each (3,360 bytes at H=16, depth 3; 10,784 at H=32; 19,232
# at depth 4), two, or for K4 one a coupling where they fit beside the
# resident stack (the demo's six); and K5's partial weight gradients where
# they fit (the demo's 3,852 words).
@pytest.mark.parametrize("d,blocks,depth,hidden,bwd,rows,nbytes", [
    # the demo: 6 couplings of 3,136 bytes, K4 with a landing slot each,
    # K5 with its partial sums
    (2, 3, 3, 16, False, 64, 6 * 3136 + 2304 + 6 * 3360),
    (2, 3, 3, 16, True, 64,
     6 * 3136 + 2 * 2304 + 3072 + 1024 + 12288 + 6144 + 512 + 2 * 3360
     + 4 * 3852),
    # the reference default: 20 couplings of 8,000 bytes, whole in both;
    # its 46,120 partial sums do not fit beside them
    (2, 10, 3, 32, False, 64, 20 * 8000 + 2304 + 2 * 10784),
    (2, 10, 3, 32, True, 64,
     20 * 8000 + 2 * 2304 + 10240 + 1024 + 20480 + 10240 + 1024
     + 2 * 10784),
    # d=8 with [32,32,32]: 20 couplings of 13,376 bytes do not fit, one
    # does
    (8, 10, 4, 32, False, 64, 13376 + 2304 + 2 * 19232),
    (8, 10, 4, 32, True, 64,
     13376 + 2 * 2304 + 40960 + 1024 + 30720 + 10240 + 1024 + 2 * 19232),
])
def test_policy_plan_matches_hand_counts(planned, d, blocks, depth, hidden,
                                         bwd, rows, nbytes):
    assert cc.mma_plan(d, blocks, depth, _widths(d, depth, hidden),
                       bwd) == (rows, nbytes)


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_policy_plan_rows_follow_the_warps(planned, warps):
    """A CTA is 16 rows a warp; at the demo K4's bytes are the staged stack
    and its landing slots (fixed) and the warps' x rows (576 bytes a
    warp)."""
    with _warps(planned, warps):
        plan = cc.mma_plan(2, 3, 3, DEMO_WIDTHS)
    assert plan == (16 * warps, 6 * 3136 + 576 * warps + 6 * 3360)


@pytest.mark.parametrize("d,depth,hidden", [(9, 3, 16), (2, 5, 16),
                                            (2, 3, 33)])
def test_policy_plan_refuses_a_stack_outside_the_kernels(planned, d, depth,
                                                         hidden):
    with pytest.raises(RuntimeError, match="coupling_mma_plan"):
        cc.mma_plan(d, 3, depth, _widths(d, depth, hidden))


@pytest.mark.parametrize("nlayers,cap", [(32, None), (33, 32)])
def test_policy_backward_shared_memory_cap(planned, nlayers, cap):
    """The policy's K5 keeps every coupling's input for its CTA's 64 rows:
    at d=8 with [32,32,32] conditioners (one coupling staged at a time,
    99,456 bytes, and 4,096 a block) it takes at most 32 blocks. Past the
    cap the backward's check raises; a forward alone, or a stack within
    the cap, goes on to the device check."""
    flow = nft.realnvp(torch.Generator().manual_seed(0), 8, (32, 32, 32),
                       nlayers=nlayers, fused=True, compute_dtype=BF,
                       device="cpu")
    fb = flow.bijector.bijectors[0]
    sels = cc._sels(fb.idx_even, fb.idx_odd, 8)
    x, leaves = torch.zeros((300, 8)), cc._leaves(fb.groups)
    kw = dict(compute_dtype=BF)
    with pytest.raises(ValueError, match="CUDA device"):
        cc._kernel_args(x, leaves, sels, 4, **kw)
    with pytest.raises(ValueError, match="CUDA device" if cap is None else
                       f"at most {cap} blocks"):
        cc._kernel_args(x, leaves, sels, 4, backward=True, **kw)


def test_policy_forward_fits_at_any_stack(planned):
    """The policy's K4 holds the whole stack where it fits, else one
    coupling: at the kernels' bounds (d=8, [32,32,32]) and 8 warps a CTA
    one coupling, the rows and the landing slots need 13,376 + 128 · 36 +
    2 · 19,232 = 56,448 bytes, so no stack is refused."""
    with _warps(planned, 8):
        need = [cc.mma_plan(d, blocks, depth, _widths(d, depth, hidden))
                for d in (2, 5, 8) for depth in (2, 3, 4)
                for hidden in (8, 16, 32) for blocks in (1, 3, 10, 400)]
        assert cc.mma_plan(8, 400, 4, _widths(8, 4, 32)).bytes == 56448
    assert max(p.bytes for p in need) <= cc.KERNEL_MAX_SMEM
