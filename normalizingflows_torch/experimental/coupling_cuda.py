"""Fused RealNVP coupling stack: CUDA kernels and plain versions.

Counterpart of `normalizingflows/jl_tpu/experimental/coupling_pallas.py`.
One call applies a whole stack of affine-coupling blocks (both conditioner
MLPs of every coupling, exp-scale-shift, log-det and combine) with no
intermediate in device memory:

* K4 ``coupling_fwd`` (``csrc/coupling.cu``): the stack forward or inverse
  with the running log-det, the port of the Pallas `_fwd_kernel`
  (`_tile_flow`, launched by `_call_fwd`). `fwd_plan` picks its tile from
  the batch: one row on H lanes while the batch is at most
  FWD_LANE_MAX_TILES lane tiles, else one row a thread.
* K5 ``coupling_bwd`` with its ``coupling_bwd_reduce`` pass: the
  hand-written backward, the port of `_bwd_kernel` (`_call_bwd`). It
  recomputes the forward, sweeps the couplings back (`_coupling_bwd`,
  `_mlp_bwd`) and sums the weight gradients over the batch in a fixed
  order, without atomics: two runs give the same bits.

Beside them are their plain torch versions: `tile_flow`, a line-by-line
transcription of `_tile_flow` (the one-hot selection products, exact picks,
are index reads here), and `tile_flow_bwd`, the manual reverse sweep of
`_bwd_kernel` written out, not taken by autograd. Note `_mlp_bwd`'s
leaky-relu slope is 1 where the activation is ≥ 0, so at a pre-activation
of exactly 0 these take slope 1 where `F.leaky_relu`'s backward (the
unfused module path) takes 0.01.

``backend="auto"`` launches the kernels for CUDA tensors and runs the plain
versions for CPU tensors; ``"plain"`` always runs the plain versions;
``"cuda"`` raises without CUDA tensors. Nothing falls back: on a CUDA tensor
a build failure, a launch error, or a shape outside the kernels' bounds
(``KERNEL_MAX_D``, ``KERNEL_MAX_WIDTH``, ``KERNEL_MAX_DEPTH``) raises. K5
runs a tile of rows (`_bwd_tile`: at small batches one row on H lanes, at
large ones one row a thread) and keeps every coupling's input tile in
shared memory, so the blocks a stack may have are capped by
``KERNEL_MAX_SMEM``: at a full lane tile 387 in float32 at d=2 with
[32,32] conditioners, 199 with [16,16], 91 in float64 at d=8 with [32,32];
at the row tile (past 128 lane tiles) 171, 199 and 14; more at smaller
batches, whose tile is smaller. A forward that autograd will differentiate
is refused past that cap too, so the failure comes before the forward
runs, not in the backward. K4 holds every coupling's padded weights where
they fit in FWD_RESIDENT_BYTES, else two couplings': at most 80,128 bytes
(float64, [32,32,32] conditioners, the lane tile), at any number of
blocks.
Each K4 launch and each K5 call (two kernels) is counted in
`ops/launches.py`.

bfloat16 (``csrc/coupling_bf16.cu``): under the bf16 ``compute_dtype``
policy (float32 x and weights) every conditioner product rounds its
operands to bfloat16 and accumulates in float32, as the Pallas kernels'
`_dot(a, b, cd)` does, forward and backward; the selections stay exact.
That is what Hopper's tensor cores compute, so the policy's K4 and K5 are
kernels of their own (``csrc/coupling_mma.cuh``, replacing `_fwd_kernel`
and `_bwd_kernel` under ``compute_dtype``): one warp a tile of 16 rows,
every conditioner product an ``mma.sync`` m16n8k16 whose float32 output
fragments, through bias and leaky ReLU, become the next layer's bfloat16
operand in registers; K5 takes the weight gradients over a CTA's rows as
the product's k. What bounds them is the float32 work around the products
and, at 16 to 256 rows, one tile's chain. `mma_plan` asks the built
library for their rows a CTA (16 a warp, four warps) and shared memory:
the whole stack staged once where it fits, else a coupling at a time.
With bfloat16 parameters
(x and weights bfloat16, no policy) the kernels read bfloat16, compute in
float32 and round each output once (y, ld, gx, the weight gradients),
where the Pallas kernel computes in bfloat16. The plain versions do the
same, in cuBLAS's summation order.

The weights are the JAX ``groups`` pytree: ``groups['even'|'odd']['s'|'t']
[layer]`` is ``(W (n_blocks, in, out), b (n_blocks, out))``, as dicts and
lists or as the `ModuleDict`/`ModuleList`/`ParameterList` of
`FusedRealNVP`. The kernels take them, and give their gradients back, as
tables of device pointers in that pytree's leaf order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..ops import launches
from ..ops.masks import cached_index

__all__ = [
    "coupling_stack_fused", "tile_flow", "tile_flow_bwd", "fwd_plan",
    "FwdPlan", "mma_plan", "MmaPlan", "KERNEL_MAX_D",
    "KERNEL_TYPES", "word_of",
    "KERNEL_MAX_WIDTH", "KERNEL_MAX_DEPTH", "KERNEL_MAX_SMEM",
]

# the bounds the kernels are instantiated for (csrc/coupling.cu): d, the
# hidden widths, and the Dense layers a conditioner (at least 2)
KERNEL_MAX_D, KERNEL_MAX_WIDTH, KERNEL_MAX_DEPTH = 8, 32, 4
# rows R of a K5/K6 lane tile by (word bytes, hidden bound H), R·H threads
# (kBwdRowsF32H16 ... in csrc/coupling_device.cuh); past LANE_MAX_TILES
# lane tiles K5 runs its row tile of ROW_TILE_ROWS rows, one a thread
BWD_ROWS = {(4, 16): 64, (4, 32): 32, (8, 16): 32, (8, 32): 16}
LANE_MAX_TILES, ROW_TILE_ROWS = 128, 64
# K4 (kFwdRows, kFwdLaneMaxTiles, kFwdResidentBytes): its row tile holds
# FWD_ROWS rows, one a thread; while the batch is at most
# FWD_LANE_MAX_TILES lane tiles of R rows it takes the lane tile, with
# K5's rows (`k5_lane_rows`); a stack whose padded weights fit in
# FWD_RESIDENT_BYTES is staged whole, a larger one a coupling at a time
FWD_ROWS, FWD_LANE_MAX_TILES = 128, 64
FWD_RESIDENT_BYTES = 48 * 1024
KERNEL_MAX_SMEM = 227 * 1024  # dynamic shared memory a block may opt into
BWD_MAX_CTAS = 1024    # K5 CTAs at most: the partial slices to sum
BACKENDS = ("auto", "plain", "cuda")
_GROUPS = ("even", "odd")
_NETS = ("s", "t")
# (x and weights' dtype, compute_dtype) the kernels are instantiated for,
# with the C entries' suffixes (csrc/coupling.cu, csrc/coupling_bf16.cu)
KERNEL_TYPES = {
    (torch.float32, None): "f32",
    (torch.float64, None): "f64",
    (torch.float32, torch.bfloat16): "f32_cbf16",
    (torch.bfloat16, None): "bf16",
}


# ---------------------------------------------------------------------------
# The groups pytree
# ---------------------------------------------------------------------------

def _leaves(groups) -> list[torch.Tensor]:
    """Leaves in the JAX pytree order: even.s, even.t, odd.s, odd.t, per
    layer W then b."""
    return [p for grp in _GROUPS for net in _NETS
            for layer in groups[grp][net] for p in (layer[0], layer[1])]


def _unflatten(leaves, depth: int) -> dict:
    it = iter(leaves)
    return {grp: {net: [(next(it), next(it)) for _ in range(depth)]
                  for net in _NETS} for grp in _GROUPS}


def _depth(groups) -> int:
    depths = {(grp, net): len(groups[grp][net])
              for grp in _GROUPS for net in _NETS}
    if len(set(depths.values())) != 1:
        raise ValueError(
            "coupling_stack_fused requires all four conditioner stacks "
            f"(even/odd × s/t) to share the same depth; got {depths}")
    return len(groups["even"]["s"])


def _sels(idx_even, idx_odd, d):
    """(idx_even, comp_even, idx_odd, comp_odd) as tuples of ints."""
    idx_even = tuple(int(i) for i in idx_even)
    idx_odd = tuple(int(i) for i in idx_odd)
    return (idx_even, tuple(i for i in range(d) if i not in set(idx_even)),
            idx_odd, tuple(i for i in range(d) if i not in set(idx_odd)))


# ---------------------------------------------------------------------------
# Plain versions: x (n, d)
# ---------------------------------------------------------------------------

def _leaky_relu(x):
    return torch.where(x >= 0, x, 0.01 * x)


def _dot(a, b, cd=None):
    """a @ b; under the bf16 policy (``cd``) with both operands rounded to
    ``cd`` and the sum taken in float32 (Pallas `_dot(a, b, cd)`), in a's
    dtype."""
    if cd is None:
        return a @ b
    return (a.to(cd).float() @ b.to(cd).float()).to(a.dtype)


def _widened(fn):
    """Run a plain version on bfloat16 x and weights in float32 and round
    each output once to bfloat16 (the bfloat16-storage kernels'
    arithmetic); other dtypes go through as they are."""
    @functools.wraps(fn)
    def run(x, groups, *rest, **kw):
        if x.dtype != torch.bfloat16:
            return fn(x, groups, *rest, **kw)
        up = _unflatten([t.float() for t in _leaves(groups)], _depth(groups))
        rest = [r.float() if isinstance(r, torch.Tensor) else r
                for r in rest]
        out = fn(x.float(), up, *rest, **kw)
        return _map_tensors(out, lambda t: t.to(torch.bfloat16))
    return run


def _map_tensors(tree, f):
    if isinstance(tree, torch.Tensor):
        return f(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, f) for k, v in tree.items()}
    return type(tree)(_map_tensors(v, f) for v in tree)


# index tensors by (index tuple, device): made once, so that a call after
# the first copies nothing from the host (and can be captured in a graph)
_INDEX: dict = {}


def _index(idx, device):
    return cached_index(_INDEX, idx, device)


def _pick(x, idx):
    return x.index_select(1, _index(idx, x.device))


def _combine(y_a, x_b, idx_a, idx_b):
    """The inverse of the partition: y[:, idx_a] = y_a, y[:, idx_b] = x_b."""
    order = sorted(range(len(idx_a) + len(idx_b)),
                   key=lambda k: (tuple(idx_a) + tuple(idx_b))[k])
    return torch.cat([y_a, x_b], dim=1).index_select(
        1, _index(tuple(order), y_a.device))


def _mlp(xb, weights, out_tanh, cd=None):
    """A Dense chain [(W, b), ...] with leaky-relu hiddens."""
    h = xb
    depth = len(weights)
    for li, (W, b) in enumerate(weights):
        h = _dot(h, W, cd) + b
        if li < depth - 1:
            h = _leaky_relu(h)
        elif out_tanh:
            h = torch.tanh(h)
    return h


def _apply_coupling(x, ld, idx_a, idx_b, s_w, t_w, inverse, cd=None):
    """One affine coupling on an (n, d) tile."""
    x_a, x_b = _pick(x, idx_a), _pick(x, idx_b)
    s = _mlp(x_b, s_w, out_tanh=True, cd=cd)
    t = _mlp(x_b, t_w, out_tanh=False, cd=cd)
    if inverse:
        y_a = (x_a - t) * torch.exp(-s)
        ld = ld - s.sum(dim=-1)
    else:
        y_a = x_a * torch.exp(s) + t
        ld = ld + s.sum(dim=-1)
    return _combine(y_a, x_b, idx_a, idx_b), ld


def _block_weights(groups, i):
    """Block i's (even s, even t, odd s, odd t) Dense lists."""
    return tuple([(layer[0][i], layer[1][i]) for layer in groups[grp][net]]
                 for grp in _GROUPS for net in _NETS)


def _couplings(groups, sels, inverse):
    """The couplings in application order: (block, group, idx_a, idx_b,
    s weights, t weights)."""
    idx_e, comp_e, idx_o, comp_o = sels
    n_blocks = groups["even"]["s"][0][0].shape[0]
    order = range(n_blocks - 1, -1, -1) if inverse else range(n_blocks)
    out = []
    for i in order:
        es, et, osw, otw = _block_weights(groups, i)
        pair = ((i, "even", idx_e, comp_e, es, et),
                (i, "odd", idx_o, comp_o, osw, otw))
        out += pair[::-1] if inverse else pair
    return out


@_widened
def tile_flow(x, groups, sels, inverse: bool = False, compute_dtype=None):
    """Plain version of K4 (Pallas `_tile_flow`): the whole stack on x
    (n, d). ``sels`` = (idx_even, comp_even, idx_odd, comp_odd);
    ``compute_dtype`` the conditioners' bf16 policy. Returns (y (n, d),
    log_det (n,))."""
    ld = x.new_zeros(x.shape[0])
    for (_, _, idx_a, idx_b, s_w, t_w) in _couplings(groups, sels, inverse):
        x, ld = _apply_coupling(x, ld, idx_a, idx_b, s_w, t_w, inverse,
                                compute_dtype)
    return x, ld


def _mlp_fwd_cache(xb, weights, out_tanh, cd=None):
    """_mlp with residuals: (out, (layer_inputs, layer_outputs))."""
    h = xb
    depth = len(weights)
    inputs, outputs = [], []
    for li, (W, b) in enumerate(weights):
        inputs.append(h)
        z = _dot(h, W, cd) + b
        if li < depth - 1:
            h = _leaky_relu(z)
        elif out_tanh:
            h = torch.tanh(z)
        else:
            h = z
        outputs.append(h)
    return h, (inputs, outputs)


def _mlp_bwd(weights, cache, gout, out_tanh, cd=None):
    """Manual reverse sweep of `_mlp`: (g_input, [(gW, gb), ...]). Slopes
    from the cached post-activations: leaky-relu 1 where h ≥ 0, else 0.01;
    tanh' = 1 − h²."""
    inputs, outputs = cache
    depth = len(weights)
    g = gout
    gws = [None] * depth
    for li in range(depth - 1, -1, -1):
        h = outputs[li]
        if li == depth - 1:
            if out_tanh:
                g = g * (1.0 - h * h)
        else:
            g = g * torch.where(h >= 0, torch.ones_like(h),
                                  torch.full_like(h, 0.01))
        W, _ = weights[li]
        gws[li] = (_dot(inputs[li].T, g, cd), g.sum(dim=0))
        g = _dot(g, W.T, cd)
    return g, gws


def _coupling_fwd_cache(x, idx_a, idx_b, s_w, t_w, cd=None):
    """What the reverse sweep needs of one coupling on its input x."""
    x_a, x_b = _pick(x, idx_a), _pick(x, idx_b)
    s, cs = _mlp_fwd_cache(x_b, s_w, out_tanh=True, cd=cd)
    t, ct = _mlp_fwd_cache(x_b, t_w, out_tanh=False, cd=cd)
    return x_a, s, t, cs, ct


def _coupling_bwd(g, gld, cache, idx_a, idx_b, s_w, t_w, inverse, cd=None):
    """Reverse sweep of one coupling. ``g`` is the cotangent of its output,
    ``gld`` (n,) that of the running log-det, which every coupling's s
    receives (ld is a plain sum over couplings)."""
    x_a, s, t, cs, ct = cache
    g_ya, g_xb = _pick(g, idx_a), _pick(g, idx_b)
    gld_b = gld[:, None].expand_as(s)
    if inverse:
        e = torch.exp(-s)
        g_xa = g_ya * e
        g_t = -g_xa
        g_s = -g_ya * (x_a - t) * e - gld_b
    else:
        e = torch.exp(s)
        g_xa = g_ya * e
        g_t = g_ya
        g_s = g_ya * x_a * e + gld_b
    gxb_s, gws_s = _mlp_bwd(s_w, cs, g_s, out_tanh=True, cd=cd)
    gxb_t, gws_t = _mlp_bwd(t_w, ct, g_t, out_tanh=False, cd=cd)
    g_xb = g_xb + gxb_s + gxb_t
    return _combine(g_xa, g_xb, idx_a, idx_b), gws_s, gws_t


@_widened
def tile_flow_bwd(x, groups, gy, gld, sels, inverse: bool = False,
                  compute_dtype=None):
    """Plain version of K5 (Pallas `_bwd_kernel`): the VJP of `tile_flow`
    at x (n, d) under cotangents gy (n, d) and gld (n,). Recomputes the
    forward keeping each coupling's input, then per coupling (last first)
    rebuilds its MLP caches and runs the manual reverse sweep. Returns
    (gx, grads) with grads shaped as ``groups`` (dicts of lists of
    (gW, gb), stacked over blocks)."""
    cd = compute_dtype
    couplings = _couplings(groups, sels, inverse)
    inputs = []
    ld0 = x.new_zeros(x.shape[0])
    for (_, _, idx_a, idx_b, s_w, t_w) in couplings:
        inputs.append(x)
        x, _ = _apply_coupling(x, ld0, idx_a, idx_b, s_w, t_w, inverse, cd)

    n_blocks = groups["even"]["s"][0][0].shape[0]
    per_block = {(grp, net): [None] * n_blocks
                 for grp in _GROUPS for net in _NETS}
    g = gy
    for (bi, grp, idx_a, idx_b, s_w, t_w), x_in in zip(couplings[::-1],
                                                         inputs[::-1]):
        cache = _coupling_fwd_cache(x_in, idx_a, idx_b, s_w, t_w, cd)
        g, gws_s, gws_t = _coupling_bwd(g, gld, cache, idx_a, idx_b, s_w,
                                        t_w, inverse, cd)
        per_block[(grp, "s")][bi] = gws_s
        per_block[(grp, "t")][bi] = gws_t
    grads = {grp: {net: [tuple(torch.stack([blk[li][k] for blk in
                                            per_block[(grp, net)]])
                               for k in (0, 1))
                         for li in range(len(groups[grp][net]))]
                   for net in _NETS} for grp in _GROUPS}
    return g, grads


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _hidden_bound(hidden: int) -> int:
    """H, the padded hidden width the kernels are instantiated for."""
    return 16 if hidden <= 16 else 32


def bwd_rows(word: int, hidden: int) -> int:
    """R, the most rows of a lane tile (`bwd_rows<T, H>`), for words of
    ``word`` bytes and a widest hidden layer of ``hidden``."""
    return BWD_ROWS[(word, _hidden_bound(hidden))]


def lane_rows(word: int, hidden: int, n: int) -> int:
    """Rows of a lane tile holding n rows (`lane_rows<T, H>`): n in whole
    warps of 32/H rows, at most R. K6's tile holds its batch."""
    per_warp = 32 // _hidden_bound(hidden)
    return min(bwd_rows(word, hidden), -(-n // per_warp) * per_warp)


def k5_lane_rows(word: int, hidden: int, n: int) -> int:
    """Rows of K5's lane tile for a batch of n rows (`k5_lane_rows<T, H>`):
    n / LANE_MAX_TILES, so that the tiles spread over the SMs, but at least
    8 warps (256/H rows) and no more than the batch."""
    want = max(-(-n // LANE_MAX_TILES), 256 // _hidden_bound(hidden))
    return lane_rows(word, hidden, min(n, want))


def _lane_smem_bytes(d, n_blocks, depth, hidden, word, rows, extra_words=0):
    """The lane tile's dynamic shared memory (`lane_bwd_words`,
    csrc/coupling_device.cuh) for ``rows`` rows, in bytes: one coupling's
    two padded nets (W's rows one word apart more than K4's), every
    coupling's saved (rows, d) input, the two nets' activations and one
    layer's cotangents; ``extra_words`` more (K6's ELBO terms)."""
    half, H = KERNEL_MAX_D // 2, _hidden_bound(hidden)
    net = (half * (H + 1) + H + (depth - 2) * (H * (H + 1) + H)
           + H * (half + 1) + half)
    acts = rows * (half + (depth - 1) * H) + rows * half
    return word * (2 * net + 2 * n_blocks * rows * d + 2 * acts + rows * H
                   + extra_words)


def _row_smem_bytes(d, n_blocks, depth, hidden, word):
    """The row tile's (`row_bwd_words`): the same parts for ROW_TILE_ROWS
    rows, W's rows unpadded, the caches unit-major with a row stride of
    ROW_TILE_ROWS + 1."""
    half, H = KERNEL_MAX_D // 2, _hidden_bound(hidden)
    rows, stride = ROW_TILE_ROWS, ROW_TILE_ROWS + 1
    net = half * H + H + (depth - 2) * (H * H + H) + H * half + half
    acts = stride * (half + (depth - 1) * H) + stride * half
    return word * (2 * net + 2 * n_blocks * rows * d + 2 * acts + stride * H)


def _bwd_tile(d, n_blocks, depth, hidden, word, n, train=False):
    """(rows, shared-memory bytes) of the tile K5 runs on n rows: the lane
    tile while n is at most LANE_MAX_TILES lane tiles, else the row tile;
    with ``train``, K6's lane tile for a batch of n with its ELBO terms."""
    n = max(n, 1)
    if train or -(-n // bwd_rows(word, hidden)) <= LANE_MAX_TILES:
        rows = (lane_rows if train else k5_lane_rows)(word, hidden, n)
        return rows, _lane_smem_bytes(d, n_blocks, depth, hidden, word, rows,
                                      rows if train else 0)
    return ROW_TILE_ROWS, _row_smem_bytes(d, n_blocks, depth, hidden, word)


class FwdPlan(NamedTuple):
    """How K4 runs: on the lane tile (``lanes``) or the row tile, ``rows``
    rows a CTA, with every coupling's weights staged at once
    (``resident``) or two couplings' at a time, in ``bytes`` of dynamic
    shared memory."""
    lanes: bool
    rows: int
    resident: bool
    bytes: int


def fwd_plan(n_blocks: int, depth: int, hidden: int, word: int,
             n: int) -> FwdPlan:
    """K4's plan for n rows of ``word``-byte words, ``n_blocks`` blocks of
    two couplings and a widest hidden layer of ``hidden`` (`launch_fwd_h`):
    the lane tile with K5's rows while n is at most FWD_LANE_MAX_TILES lane
    tiles of R rows, else the row tile. A coupling's padded weights (both
    nets, W's rows one word apart more in the lane tile's; `fwd_words`) are
    held for every coupling where the stack fits in FWD_RESIDENT_BYTES,
    else for two."""
    n = max(n, 1)
    lanes = -(-n // bwd_rows(word, hidden)) <= FWD_LANE_MAX_TILES
    half, H, pad = KERNEL_MAX_D // 2, _hidden_bound(hidden), int(lanes)
    net = (half * (H + pad) + H + (depth - 2) * (H * (H + pad) + H)
           + H * (half + pad) + half)
    rows = k5_lane_rows(word, hidden, n) if lanes else FWD_ROWS
    stack = word * 2 * n_blocks * 2 * net
    resident = stack <= FWD_RESIDENT_BYTES
    return FwdPlan(lanes, rows, resident,
                   stack if resident else word * 2 * 2 * net)


class MmaPlan(NamedTuple):
    """How the policy's K4 or K5 runs: ``rows`` rows a CTA, in ``bytes``
    of dynamic shared memory."""
    rows: int
    bytes: int


def mma_plan(d: int, n_blocks: int, depth: int, widths,
             backward: bool = False) -> MmaPlan:
    """The policy's K4 (or with ``backward`` K5) plan for a stack of the C
    interface's ``widths``, from the built library (`coupling_mma_plan`:
    the layout its launches take). Past KERNEL_MAX_SMEM only where K5's
    saved inputs do not fit."""
    from ..ops._build import library

    out = (ctypes.c_longlong * 2)()
    _raise_on(library().coupling_mma_plan(
        d, n_blocks, depth, (ctypes.c_int * len(widths))(*widths),
        int(backward), out), "coupling_mma_plan")
    return MmaPlan(*out)


def _hidden_of(widths, depth: int) -> int:
    """The widest hidden layer of the C interface's widths array."""
    return max(widths[g * (depth + 1) + l] for g in (0, 1)
               for l in range(1, depth))


def word_of(dtype) -> int:
    """Bytes of the kernels' shared-memory words for x and weights of
    ``dtype``: the arithmetic's, so 4 for bfloat16, whose staged weights
    and caches are held widened."""
    return 4 if dtype == torch.bfloat16 else torch.finfo(dtype).bits // 8


def _kernel_args(x, leaves, sels, depth, backward=False, train_batch=None,
                 compute_dtype=None):
    """Check what the kernels take (shapes first, then dtype and device):
    the shared memory of K4's tile for x's rows (without ``train_batch``);
    with ``backward`` also that of K5's tile for x's rows, or with
    ``train_batch`` that of K6's tile for that batch. Returns (suffix,
    widths, idx) with the int arrays of the C interface."""
    n, d = x.shape
    groups = _unflatten(leaves, depth)
    widths = []
    for grp in _GROUPS:
        w = [groups[grp]["s"][0][0].shape[1]] + [
            W.shape[2] for W, _ in groups[grp]["s"]]
        if [groups[grp]["t"][0][0].shape[1]] + [
                W.shape[2] for W, _ in groups[grp]["t"]] != w:
            raise ValueError("the s and t conditioners of a coupling must "
                             "have the same widths")
        widths += w
    if not (2 <= d <= KERNEL_MAX_D and 2 <= depth <= KERNEL_MAX_DEPTH
            and max(widths) <= KERNEL_MAX_WIDTH):
        raise ValueError(
            f"outside the coupling kernels' instantiated bounds (2 <= d <= "
            f"{KERNEL_MAX_D}, widths <= {KERNEL_MAX_WIDTH}, 2 <= depth <= "
            f"{KERNEL_MAX_DEPTH}): d={d}, widths={widths}, depth={depth}")
    typed = x.dtype in (torch.float32, torch.float64, torch.bfloat16)
    n_blocks, hidden = leaves[0].shape[0], _hidden_of(widths, depth)
    # the policy's K4 needs at most one coupling's slot and its rows (its
    # largest need is far below the cap); its K5 holds every coupling's
    # input, so the blocks it takes are capped
    policy = compute_dtype is not None and train_batch is None
    if train_batch is None and typed and not policy:
        need = fwd_plan(n_blocks, depth, hidden, word_of(x.dtype), n).bytes
        if need > KERNEL_MAX_SMEM:
            raise ValueError(
                f"the forward's two staged couplings need {need} bytes of "
                f"shared memory at depth {depth} in {x.dtype}, over the "
                f"{KERNEL_MAX_SMEM} a block may use")
    if backward and typed:
        word = word_of(x.dtype)
        if policy:
            rows, need = mma_plan(d, n_blocks, depth, widths, True)
        else:
            rows, need = _bwd_tile(
                d, n_blocks, depth, hidden, word,
                n if train_batch is None else train_batch,
                train_batch is not None)
        if need > KERNEL_MAX_SMEM:
            cap = n_blocks - -(-(need - KERNEL_MAX_SMEM)
                               // (2 * rows * d * word))
            raise ValueError(
                f"the backward sweep needs {need} bytes of shared memory for "
                f"{n_blocks} blocks at d={d} in {x.dtype}, over the "
                f"{KERNEL_MAX_SMEM} a block may use; this shape takes at "
                f"most {cap} blocks")
    idx_e, comp_e, idx_o, comp_o = sels
    if (widths[0], widths[depth]) != (len(comp_e), len(idx_e)) or (
            widths[depth + 1], widths[-1]) != (len(comp_o), len(idx_o)):
        raise ValueError("the conditioner widths do not match the index sets")
    if (x.dtype, compute_dtype) not in KERNEL_TYPES or any(
            t.dtype != x.dtype for t in leaves):
        raise TypeError(
            "the coupling kernels take x and weights of one dtype with a "
            f"compute_dtype in {[tuple(map(str, k)) for k in KERNEL_TYPES]}"
            f", got {x.dtype} and {compute_dtype}")
    if not x.is_cuda or any(t.device != x.device for t in leaves):
        raise ValueError("the coupling kernels need x and every weight on "
                         "one CUDA device")
    if not all(t.is_contiguous() for t in leaves):
        raise ValueError("stacked weights must be contiguous")
    c_int = ctypes.c_int
    return (KERNEL_TYPES[(x.dtype, compute_dtype)],
            (c_int * len(widths))(*widths),
            (c_int * (2 * d))(*(idx_e + comp_e + idx_o + comp_o)))


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} (1 is "
                           "an invalid value: a shape or a shared-memory "
                           "need outside what the kernel takes)")


def _launch_fwd(x, leaves, sels, depth, inverse, backward=False,
                compute_dtype=None):
    """K4 on x (n, d) contiguous, on the tile `fwd_plan` picks (under the
    policy its one tile, which the C entry sizes itself).
    ``backward``: K5 will follow, so its bounds are checked before K4
    runs."""
    from ..ops._build import library

    sfx, widths, idx = _kernel_args(x, leaves, sels, depth, backward,
                                    compute_dtype=compute_dtype)
    n, d = x.shape
    y, ld = torch.empty_like(x), x.new_empty(n)
    if n == 0:
        return y, ld
    lanes = compute_dtype is None and fwd_plan(
        leaves[0].shape[0], depth, _hidden_of(widths, depth),
        word_of(x.dtype), n).lanes
    with torch.cuda.device(x.device):
        err = getattr(library(), f"coupling_fwd_{sfx}")(
            x.data_ptr(), y.data_ptr(), ld.data_ptr(), n, d,
            leaves[0].shape[0], depth, widths, idx, _pointers(leaves),
            int(lanes), int(inverse),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "coupling_fwd")
    launches.count(launches.name_of("coupling_fwd", sfx))
    return y, ld


def _launch_bwd(x, leaves, gy, gld, sels, depth, inverse,
                compute_dtype=None):
    """K5 (both passes): gx and one gradient per stacked weight. The
    partial sums' scratch is in the arithmetic's dtype (float32 for
    bfloat16 storage: each gradient is rounded once, by the reduce)."""
    from ..ops._build import library

    sfx, widths, idx = _kernel_args(x, leaves, sels, depth, backward=True,
                                    compute_dtype=compute_dtype)
    n, d = x.shape
    gy, gld = gy.contiguous(), gld.contiguous()
    gx = torch.empty_like(x)
    grads = [torch.empty_like(t) for t in leaves]
    if n == 0:
        return gx, [g.zero_() for g in grads]
    rows = (mma_plan(d, leaves[0].shape[0], depth, widths, True).rows
            if compute_dtype is not None else
            _bwd_tile(d, leaves[0].shape[0], depth, _hidden_of(widths, depth),
                      word_of(x.dtype), n)[0])
    n_ctas = min(-(-n // rows), BWD_MAX_CTAS)
    scratch = torch.empty(n_ctas * sum(t.numel() for t in leaves),
                          dtype=torch.float32 if x.dtype == torch.bfloat16
                          else x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(library(), f"coupling_bwd_{sfx}")(
            x.data_ptr(), gy.data_ptr(), gld.data_ptr(), gx.data_ptr(),
            scratch.data_ptr(), n, d, leaves[0].shape[0], depth, widths, idx,
            _pointers(leaves), _pointers(grads), n_ctas, int(inverse),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "coupling_bwd")
    launches.count(launches.name_of("coupling_bwd", sfx))
    return gx, grads


class _CouplingFused(torch.autograd.Function):
    """x (n, d) contiguous and the stacked weights (leaf order) → (y, ld).
    Saves x and the weights and recomputes in the backward, as the Pallas
    custom VJP does (`_fused_fwd`)."""

    @staticmethod
    def forward(ctx, x, meta, *leaves):
        sels, depth, inverse, use_kernel, backward, cd = meta
        ctx.save_for_backward(x, *leaves)
        ctx.meta = meta
        if use_kernel:
            return _launch_fwd(x, leaves, sels, depth, inverse, backward, cd)
        return tile_flow(x, _unflatten(leaves, depth), sels, inverse, cd)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gld):
        x, *leaves = ctx.saved_tensors
        sels, depth, inverse, use_kernel, _, cd = ctx.meta
        if use_kernel:
            gx, grads = _launch_bwd(x, leaves, gy, gld, sels, depth, inverse,
                                    cd)
        else:
            gx, tree = tile_flow_bwd(x, _unflatten(leaves, depth), gy, gld,
                                     sels, inverse, cd)
            grads = _leaves(tree)
        return (gx, None, *grads)


def _use_kernel(backend: str, x: torch.Tensor) -> bool:
    if backend == "auto":
        return x.is_cuda
    if backend == "plain":
        return False
    if backend == "cuda":
        if not x.is_cuda:
            raise ValueError("backend='cuda' needs CUDA tensors")
        return True
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def coupling_stack_fused(x, groups, idx_even, idx_odd, inverse: bool = False,
                         backend: str = "auto", compute_dtype=None):
    """Fused RealNVP stack transform (JAX `coupling_stack_fused`).

    ``x``: (..., d). ``groups``: {'even'|'odd': {'s'|'t': [(W, b), ...]}}
    with the leading block axis stacked. ``idx_even``/``idx_odd``: the
    transformed index sets of the two couplings of each block.
    ``compute_dtype``: None, or torch.bfloat16 for the conditioners' bf16
    policy. Returns (y, log_det) with log_det shaped (...,)."""
    batch_shape, d = x.shape[:-1], x.shape[-1]
    depth = _depth(groups)
    use_kernel = _use_kernel(backend, x)
    sels = _sels(idx_even, idx_odd, d)
    leaves = _leaves(groups)
    backward = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, *leaves])
    y, ld = _CouplingFused.apply(x.reshape(-1, d).contiguous(),
                                 (sels, depth, bool(inverse), use_kernel,
                                  backward, compute_dtype), *leaves)
    return y.reshape(x.shape), ld.reshape(batch_shape)
