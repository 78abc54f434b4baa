"""Fused rational-quadratic-spline transform: CUDA kernels and plain tiles.

Counterpart of `normalizingflows/jl_tpu/ops/rqs_pallas.py`. One call maps
x and its element's 3K−1 raw conditioner outputs to the spline value and
its log-derivative, so the (K+1)-knot tables never touch device memory:

* K1 ``rqs_fwd`` (``csrc/rqs.cu``): the forward or inverse spline, the port
  of the Pallas `_fwd_kernel` (`_tile_tables` + `_tile_transform`).
* K2 ``rqs_bwd_fwddir``: the closed-form VJP of the forward direction, the
  port of `_bwd_kernel` with `_tile_bwd_analytic`.
* K3 ``rqs_bwd_invdir``: the closed-form VJP of the inverse direction by
  the implicit function theorem, the port of `_bwd_kernel` with
  `_tile_bwd_analytic_inverse` (the density path: `log_prob` gradients).

Beside each kernel is its plain torch version (`tile_transform`,
`tile_bwd_analytic`, `tile_bwd_analytic_inverse`), a line-by-line
transcription of the Pallas tile in the elem-major (N, 3K−1) layout.
``backend="auto"`` launches the kernels for CUDA tensors and runs the plain
versions for CPU tensors; nothing falls back: on a CUDA tensor a build
failure, a launch error, or a K or dtype the kernels do not take raises.
Each launch of K1, K2 or K3 is counted in `ops/launches.py`.

raw may be stored in another dtype than x: the kernels are instantiated
for (x, raw) in (float32, float32), (float64, float64), (float32,
bfloat16) — the conditioner's raw under the bf16 ``compute_dtype``
policy, as the JAX Pallas path feeds it — and (bfloat16, bfloat16), for
bfloat16 parameters (``csrc/rqs.cu``, ``csrc/rqs_bf16.cu``). raw is
widened where it is read and graw written in raw's dtype. A bfloat16 x is
computed in float32 and each output rounded once; the plain versions do
the same, so kernel and plain version keep identical bits (the JAX kernel
computes a bfloat16 x in bfloat16).

Every kernel stages elem-major raw through shared memory, one tile a CTA,
so that its device-memory loads coalesce: K1 copies its tile in by
``cp.async``; K2/K3 also copy their graw tile out of it. Param-major raw is
read directly. `fwd_plan` and `bwd_plan` decide the path and the tile's
shared row stride, which the C entries take.

The JAX module's layout entries all reach the same three kernels through
raw's strides, with no transpose and no copy of raw: `rqs_fused` (raw
(..., 3K−1)), `rqs_fused_t` (param-major (3K−1, N)) and `rqs_fused_e`
(elem-major (N, P ≥ 3K−1), pad columns ignored and given zero cotangent).
The Pallas rows layout (`_call_fwd_rows`: x (R, N/R), raw (3K−1, R, N/R))
is `rqs_fused_t` over the flattened views of those tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from . import launches
from . import rqs as _oracle

__all__ = [
    "rqs_fused", "rqs_fused_t", "rqs_fused_e", "rqs_fused_vjp",
    "rqs_fused_forward", "rqs_fused_inverse", "tile_transform",
    "tile_bwd_analytic", "tile_bwd_analytic_inverse", "fwd_plan", "FwdPlan",
    "bwd_plan", "BwdPlan", "KERNEL_K", "KERNEL_TYPES", "raw_dtype_for",
]

# K values and (x, raw) dtypes the kernels are instantiated for, with the
# C entries' suffixes (csrc/rqs.cu, csrc/rqs_bf16.cu)
KERNEL_K = (8, 10)
KERNEL_TYPES = {
    (torch.float32, torch.float32): "f32",
    (torch.float64, torch.float64): "f64",
    (torch.float32, torch.bfloat16): "f32_rbf16",
    (torch.bfloat16, torch.bfloat16): "bf16",
}
BACKENDS = ("auto", "plain", "cuda")
# K1, K2 and K3: the CTA's threads and a staged tile's rows, one thread an
# element (kThreads in csrc/rqs.cu), and the dynamic shared memory a block
# may opt into
BWD_ROWS = 256
KERNEL_MAX_SMEM = 227 * 1024


def raw_dtype_for(x_dtype, raw_dtype):
    """The dtype raw is read in beside an x of ``x_dtype``: its own where
    the kernels take the pair, else x's."""
    return raw_dtype if (x_dtype, raw_dtype) in KERNEL_TYPES else x_dtype


def _arith(dtype):
    """The arithmetic's dtype for an x of ``dtype``: float32 for bfloat16."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


# ---------------------------------------------------------------------------
# Plain tiles: x (N,), raw (N, 3K−1) with any strides, tables (N, K). Each
# computes in `_arith(x.dtype)`, raw widened, and rounds its outputs once
# to x's dtype (graw to raw's).
# ---------------------------------------------------------------------------

def _rev_cumsum_cols(a):
    """Exact right-to-left running sum over the K columns, the VJP of the
    left-to-right one (Pallas `_rev_cumsum_rows`)."""
    K = a.shape[1]
    cols = [a[:, K - 1:K]]
    for j in range(K - 2, -1, -1):
        cols.append(cols[-1] + a[:, j:j + 1])
    return torch.cat(cols[::-1], dim=1)


def _tile_tables(raw, B, K, dtype):
    """Knot tables from raw parameters (Pallas `_tile_tables`): per-bin
    lo/hi views of the x-knots, y-knots and derivatives, plus what the
    backward needs again (softmax probabilities, raw derivative slots)."""
    mbw = _oracle.DEFAULT_MIN_BIN_WIDTH
    mbh = _oracle.DEFAULT_MIN_BIN_HEIGHT
    mder = _oracle.DEFAULT_MIN_DERIVATIVE
    # one layout for the elementwise math, so every stride of raw rounds alike
    raw = raw.to(dtype).contiguous()
    w_raw, h_raw, d_raw = raw[:, :K], raw[:, K:2 * K], raw[:, 2 * K:]

    # softmax and running sums add left to right, in the kernel's order
    p_w = _oracle.softmax(w_raw)
    p_h = _oracle.softmax(h_raw)
    xs_hi = -B + (2.0 * B) * _oracle._exact_cumsum(mbw + (1.0 - mbw * K) * p_w)
    ys_hi = -B + (2.0 * B) * _oracle._exact_cumsum(mbh + (1.0 - mbh * K) * p_h)

    def lo_hi(hi):
        # knot k of bin k is hi[k−1] (−B for k=0); the last hi is pinned at B
        lo = torch.cat([torch.full_like(hi[:, :1], -B), hi[:, :-1]], dim=1)
        return lo, torch.cat([hi[:, :-1], torch.full_like(hi[:, :1], B)], 1)

    xs_lo, xs_hi = lo_hi(xs_hi)
    ys_lo, ys_hi = lo_hi(ys_hi)
    interior = mder + _oracle.softplus(d_raw)
    one = torch.ones_like(interior[:, :1])
    d_lo = torch.cat([one, interior], dim=1)   # d at knot k
    d_hi = torch.cat([interior, one], dim=1)   # d at knot k+1
    return xs_lo, xs_hi, ys_lo, ys_hi, d_lo, d_hi, p_w, p_h, d_raw


def _pick_bin(v, grid_lo, tables, K):
    """Bin index by compare-and-count, then a one-hot pick of each table."""
    k = ((v[:, None] >= grid_lo).sum(dim=1) - 1).clamp(0, K - 1)
    onehot = (torch.arange(K, device=v.device) == k[:, None]).to(v.dtype)
    return onehot, [(t * onehot).sum(dim=1) for t in tables]


def tile_transform(x, raw, B: float, inverse: bool = False):
    """Plain version of K1 (Pallas `_tile_transform`): x (N,), raw
    (N, 3K−1) → (out, elementwise log|d out/d x|), each (N,) in x's
    dtype."""
    K = (raw.shape[1] + 1) // 3
    B = float(B)
    x_dtype, x = x.dtype, x.to(_arith(x.dtype))
    (xs_lo, xs_hi, ys_lo, ys_hi, d_lo, d_hi, _, _, _) = _tile_tables(
        raw, B, K, x.dtype)
    inside = (x >= -B) & (x <= B)
    v = x.clamp(-B, B)
    _, (x_k, x_k1, y_k, y_k1, d_k, d_k1) = _pick_bin(
        v, ys_lo if inverse else xs_lo,
        (xs_lo, xs_hi, ys_lo, ys_hi, d_lo, d_hi), K)

    # roundoff guard: a degenerate bin never reaches log(0) or a 0-division
    tiny = 1e-6 * 2.0 * B
    w = torch.clamp_min(x_k1 - x_k, tiny)
    h = torch.clamp_min(y_k1 - y_k, tiny)
    s = h / w
    dsum = d_k1 + d_k - 2.0 * s
    if not inverse:
        xi = (v - x_k) / w
    else:
        dy = v - y_k
        a = h * (s - d_k) + dy * dsum
        b = h * d_k - dy * dsum
        c = -s * dy
        disc = torch.clamp_min(b * b - 4.0 * a * c, 0.0)
        xi = (2.0 * c / (-b - torch.sqrt(disc))).clamp(0.0, 1.0)

    xi1m = 1.0 - xi
    xi_prod = xi * xi1m
    denom = s + dsum * xi_prod
    deriv_num = (s * s) * (
        d_k1 * xi * xi + 2.0 * s * xi_prod + d_k * xi1m * xi1m)
    ld = torch.log(deriv_num) - 2.0 * torch.log(denom)
    if not inverse:
        out = y_k + h * (s * xi * xi + d_k * xi_prod) / denom
    else:
        out = x_k + xi * w
        ld = -ld
    out = torch.where(inside, out, x)
    ld = torch.where(inside, ld, torch.zeros_like(ld))
    return out.to(x_dtype), ld.to(x_dtype)


def _bin_of(x, raw, B, K, inverse):
    """What both backward tiles recompute: the tables, the bin of each
    element (found on the y-knots for the inverse) and its clamped spans
    with the clamps' gradient gates."""
    (xs_lo, xs_hi, ys_lo, ys_hi, d_lo, d_hi,
     p_w, p_h, d_raw) = _tile_tables(raw, B, K, x.dtype)
    inside = (x >= -B) & (x <= B)
    v = x.clamp(-B, B)
    onehot, (x_k, x_k1, y_k, y_k1, d_k, d_k1) = _pick_bin(
        v, ys_lo if inverse else xs_lo,
        (xs_lo, xs_hi, ys_lo, ys_hi, d_lo, d_hi), K)
    tiny = 1e-6 * 2.0 * B
    w_span, h_span = x_k1 - x_k, y_k1 - y_k
    w = torch.clamp_min(w_span, tiny)
    h = torch.clamp_min(h_span, tiny)
    w_gate = (w_span > tiny).to(x.dtype)  # gradient gates of the clamps
    h_gate = (h_span > tiny).to(x.dtype)
    return (inside, v, onehot, x_k, y_k, d_k, d_k1, w, h, w_gate, h_gate,
            (p_w, p_h, d_raw))


def _endpoints_to_raw(onehot, g_xk, g_xk1, g_yk, g_yk1, g_dk, g_dk1, norm,
                      B, K, dtype):
    """The bin's endpoint gradients back to raw (N, 3K−1): widths and
    heights through the cumsum and softmax, interior derivatives through
    the softplus."""
    p_w, p_h, d_raw = norm
    mbw = _oracle.DEFAULT_MIN_BIN_WIDTH
    mbh = _oracle.DEFAULT_MIN_BIN_HEIGHT

    def table_to_raw(g_lo_k, g_hi_k, p, min_bin):
        # hi row j and lo row j+1 both read cumsum output j; the pinned
        # +B (hi) and −B (lo) rows carry no gradient
        g_lo, g_hi = onehot * g_lo_k[:, None], onehot * g_hi_k[:, None]
        g_c = (2.0 * B) * (g_hi[:, :-1] + g_lo[:, 1:])
        g_c = torch.cat([g_c, torch.zeros_like(g_c[:, :1])], dim=1)
        g_soft = (1.0 - min_bin * K) * _rev_cumsum_cols(g_c)
        dot = _oracle._exact_sum(p * g_soft)  # softmax VJP: p ⊙ (g − Σ p·g)
        return p * (g_soft - dot)

    g_w_raw = table_to_raw(g_xk, g_xk1, p_w, mbw)
    g_h_raw = table_to_raw(g_yk, g_yk1, p_h, mbh)
    # d_lo = [1, interior], d_hi = [interior, 1]; softplus' VJP is sigmoid
    g_interior = (onehot * g_dk[:, None])[:, 1:] + \
        (onehot * g_dk1[:, None])[:, :-1]
    g_d_raw = torch.sigmoid(d_raw) * g_interior
    return torch.cat([g_w_raw, g_h_raw, g_d_raw], dim=1).to(dtype)


def tile_bwd_analytic(x, raw, gy, gld, B: float):
    """Plain version of K2 (Pallas `_tile_bwd_analytic`): the closed-form
    VJP of the forward tile. Returns gx (N,) in x's dtype and graw
    (N, 3K−1) in raw's. Reverse of Durkan et al. eqs. 4–8 through the
    softmax, cumsum and softplus normalisation; outside the box gx = gy and
    graw = 0."""
    K = (raw.shape[1] + 1) // 3
    B = float(B)
    x_dtype, cd = x.dtype, _arith(x.dtype)
    x, gy, gld = x.to(cd), gy.to(cd), gld.to(cd)
    (inside, v, onehot, x_k, y_k, d_k, d_k1, w, h, w_gate, h_gate,
     norm) = _bin_of(x, raw, B, K, inverse=False)
    s = h / w
    dsum = d_k1 + d_k - 2.0 * s

    xi = (v - x_k) / w
    xi1m = 1.0 - xi
    q = xi * xi1m
    D = s + dsum * q
    Ny = s * xi * xi + d_k * q
    R = d_k1 * xi * xi + 2.0 * s * q + d_k * xi1m * xi1m
    P = (s * s) * R

    zero = torch.zeros_like(gy)
    gy_in = torch.where(inside, gy, zero)
    gld_in = torch.where(inside, gld, zero)

    gD = gy_in * (-h * Ny / (D * D)) + gld_in * (-2.0 / D)
    gP = gld_in / P
    gNy = gy_in * h / D
    g_xi = (gD * dsum * (1.0 - 2.0 * xi)
            + gNy * (2.0 * s * xi + d_k * (1.0 - 2.0 * xi))
            + gP * (s * s) * (2.0 * d_k1 * xi + 2.0 * s * (1.0 - 2.0 * xi)
                              - 2.0 * d_k * xi1m))
    g_s = (gD * (1.0 - 2.0 * q)
           + gNy * xi * xi
           + gP * (2.0 * s * R + 2.0 * (s * s) * q))
    g_dk = gD * q + gNy * q + gP * (s * s) * xi1m * xi1m
    g_dk1 = gD * q + gP * (s * s) * xi * xi

    # s = h/w, ξ = (v − x_k)/w, then through the clamps to the endpoints
    g_h = (gy_in * Ny / D + g_s / w) * h_gate
    g_w = (-g_s * h / (w * w) - g_xi * xi / w) * w_gate
    g_v = g_xi / w
    g_xk = -g_w - g_xi / w
    g_yk = gy_in - g_h

    graw = _endpoints_to_raw(onehot, g_xk, g_w, g_yk, g_h, g_dk, g_dk1, norm,
                             B, K, raw.dtype)
    return torch.where(inside, g_v, gy).to(x_dtype), graw


def tile_bwd_analytic_inverse(x, raw, g_out, gld, B: float):
    """Plain version of K3 (Pallas `_tile_bwd_analytic_inverse`): the VJP
    of the inverse tile by implicit differentiation. The inverse finds the
    root ξ* of Y(ξ; θ) = v and emits out = x_k + ξ*·w and the negated
    log-det; ∂ξ*/∂θ = −(∂Y/∂θ)/(∂Y/∂ξ) with ∂Y/∂ξ = w·P/D². ``g_out`` and
    ``gld`` are the cotangents of those outputs. Returns gx (N,) in x's
    dtype and graw (N, 3K−1) in raw's; outside the box gx = g_out and graw
    = 0."""
    K = (raw.shape[1] + 1) // 3
    B = float(B)
    x_dtype, cd = x.dtype, _arith(x.dtype)
    x, g_out, gld = x.to(cd), g_out.to(cd), gld.to(cd)
    (inside, v, onehot, x_k, y_k, d_k, d_k1, w, h, w_gate, h_gate,
     norm) = _bin_of(x, raw, B, K, inverse=True)
    s = h / w
    dsum = d_k1 + d_k - 2.0 * s

    # ξ* exactly as the inverse tile solves it
    dy = v - y_k
    a = h * (s - d_k) + dy * dsum
    b = h * d_k - dy * dsum
    c = -s * dy
    disc = torch.clamp_min(b * b - 4.0 * a * c, 0.0)
    xi = (2.0 * c / (-b - torch.sqrt(disc))).clamp(0.0, 1.0)

    xi1m = 1.0 - xi
    q = xi * xi1m
    D = s + dsum * q
    Ny = s * xi * xi + d_k * q
    R = d_k1 * xi * xi + 2.0 * s * q + d_k * xi1m * xi1m
    P = (s * s) * R

    zero = torch.zeros_like(g_out)
    g_out_in = torch.where(inside, g_out, zero)
    gld_in = torch.where(inside, gld, zero)

    # ld_out = −(log P − 2 log D): explicit partials at fixed ξ
    gP_e = -gld_in / P
    gD_e = 2.0 * gld_in / D
    g_s_e = gD_e * (1.0 - 2.0 * q) + gP_e * (2.0 * s * R
                                             + 2.0 * (s * s) * q)
    g_dk_e = gD_e * q + gP_e * (s * s) * xi1m * xi1m
    g_dk1_e = gD_e * q + gP_e * (s * s) * xi * xi

    # total cotangent reaching ξ: out = x_k + ξw, plus ld's ξ-derivative
    Dp = dsum * (1.0 - 2.0 * xi)                           # D'(ξ)
    Pp = (s * s) * (2.0 * d_k1 * xi + 2.0 * s * (1.0 - 2.0 * xi)
                    - 2.0 * d_k * xi1m)                    # P'(ξ)
    g_xi_tot = g_out_in * w - gld_in * (Pp / P - 2.0 * Dp / D)

    # implicit function: Y(ξ) = y_k + h·Ny/D = v; ∂Y/∂ξ = w·P/D²
    dYdxi = w * P / (D * D)
    coef = -g_xi_tot / dYdxi                              # ∂ξ/∂θ factor

    # ∂Y/∂θ at fixed ξ (forward-map partials); ∂Y/∂y_k = 1
    Y_s = h * (xi * xi * D - Ny * (1.0 - 2.0 * q)) / (D * D)
    Y_dk = h * q * (D - Ny) / (D * D)
    Y_dk1 = -h * Ny * q / (D * D)
    Y_h_dir = Ny / D

    g_s_tot = g_s_e + coef * Y_s
    g_dk = g_dk_e + coef * Y_dk
    g_dk1 = g_dk1_e + coef * Y_dk1
    g_h_dir = coef * Y_h_dir
    # v reaches ξ through Y(ξ*) = v: ∂ξ/∂v = 1/(∂Y/∂ξ)
    g_v = g_xi_tot / dYdxi

    # knot-endpoint grads, through the clamps
    g_w = (g_out_in * xi - g_s_tot * h / (w * w)) * w_gate
    g_h = (g_h_dir + g_s_tot / w) * h_gate
    g_xk = g_out_in - g_w
    g_yk = coef - g_h

    graw = _endpoints_to_raw(onehot, g_xk, g_w, g_yk, g_h, g_dk, g_dk1, norm,
                             B, K, raw.dtype)
    return torch.where(inside, g_v, g_out).to(x_dtype), graw


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _kernel_args(x, raw, K):
    if K not in KERNEL_K:
        raise ValueError(f"the RQS kernels are built for K in {KERNEL_K}, "
                         f"got K={K}")
    if (x.dtype, raw.dtype) not in KERNEL_TYPES:
        raise TypeError("the RQS kernels take (x, raw) in "
                        f"{[tuple(map(str, k)) for k in KERNEL_TYPES]}, got "
                        f"{x.dtype} and {raw.dtype}")
    if not (x.is_cuda and raw.device == x.device):
        raise ValueError("the RQS kernels need x and raw on one CUDA device")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return KERNEL_TYPES[(x.dtype, raw.dtype)]


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


class FwdPlan(NamedTuple):
    """How K1 runs: ``staged`` through a shared-memory tile of
    ``BWD_ROWS`` elements whose rows are ``stride`` words apart (``bytes``
    of dynamic shared memory), or direct (``stride`` and ``bytes`` 0)."""
    staged: bool
    stride: int
    bytes: int


def fwd_plan(stride_elem: int, K: int, word: int) -> FwdPlan:
    """K1's plan for raw's stride between elements, K and ``word``-byte
    words. Param-major raw (stride_elem 1) is coalesced as it is and runs
    direct; every elem-major raw (the conditioner's dense (N, 3K−1) view,
    padded, any row stride) is staged: its 3K−1 columns copied into a tile
    whose shared row stride is odd and ≥ 3K−1, so a warp's rows fall in
    distinct banks. Raises ValueError where the tile would need more than
    ``KERNEL_MAX_SMEM``."""
    if stride_elem == 1:
        return FwdPlan(False, 0, 0)
    stride = (3 * K - 1) | 1
    need = BWD_ROWS * stride * word
    if need > KERNEL_MAX_SMEM:
        raise ValueError(
            f"K1's staged tile needs {need} bytes of shared memory for "
            f"{BWD_ROWS} rows of {stride} {word}-byte words, over the "
            f"{KERNEL_MAX_SMEM} a block may use")
    return FwdPlan(True, stride, need)


def _launch_fwd(x, raw, B, K, inverse):
    """K1 on x (N,) and raw (N, P ≥ 3K−1) read through its strides, as
    `fwd_plan` says."""
    from ._build import library

    sfx = _kernel_args(x, raw, K)
    y, ld = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return y, ld
    plan = fwd_plan(raw.stride(0), K, raw.element_size())
    # the C entry launches on the current device: make it x's for the call
    # and restore the caller's after
    with torch.cuda.device(x.device):
        err = getattr(library(), f"rqs_fwd_{sfx}")(
            x.data_ptr(), raw.data_ptr(), y.data_ptr(), ld.data_ptr(),
            x.numel(), raw.stride(0), raw.stride(1), int(plan.staged),
            plan.stride, K, B, int(inverse),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "rqs_fwd")
    launches.count(launches.name_of("rqs_fwd", sfx))
    return y, ld


class BwdPlan(NamedTuple):
    """How K2/K3 run: ``staged`` through a shared-memory tile of ``rows``
    elements whose rows are ``stride`` words apart (``bytes`` of dynamic
    shared memory), or direct (``stride`` and ``bytes`` 0)."""
    staged: bool
    rows: int
    stride: int
    bytes: int


def bwd_plan(stride_elem: int, gcols: int, K: int, word: int) -> BwdPlan:
    """K2/K3's plan for raw's stride between elements and graw's gcols ≥
    3K−1 columns of ``word`` bytes. Param-major raw (stride_elem 1) is
    coalesced as it is and runs direct; elem-major raw is staged, at every
    size (on the H100 the tile was faster than the direct read from one
    CTA up), with an odd row stride ≥ gcols, so a warp's rows fall in
    distinct banks. Raises ValueError where the tile would need more than
    ``KERNEL_MAX_SMEM``."""
    if stride_elem == 1:
        return BwdPlan(False, BWD_ROWS, 0, 0)
    stride = max(gcols, 3 * K - 1) | 1
    need = BWD_ROWS * stride * word
    if need > KERNEL_MAX_SMEM:
        raise ValueError(
            f"the RQS backward's staged tile needs {need} bytes of shared "
            f"memory for {gcols} columns of {word}-byte words, over the "
            f"{KERNEL_MAX_SMEM} a block may use; at most "
            f"{(KERNEL_MAX_SMEM // (BWD_ROWS * word) - 1) | 1} columns")
    return BwdPlan(True, BWD_ROWS, stride, need)


def _launch_bwd(x, raw, gy, gld, B, K, inverse):
    """K2 (forward direction) or K3 (inverse direction), as `bwd_plan`
    says. graw takes raw's layout (strides and pad columns; `empty_like`
    keeps the strides of a dense tensor) and the kernel writes every column
    of it, the pad with exact zeros."""
    from ._build import library

    sfx = _kernel_args(x, raw, K)
    gy, gld = gy.contiguous(), gld.contiguous()
    gx, graw = torch.empty_like(x), torch.empty_like(raw)
    if x.numel() == 0:
        return gx, graw
    plan = bwd_plan(raw.stride(0), graw.shape[1], K, raw.element_size())
    name = "rqs_bwd_invdir" if inverse else "rqs_bwd_fwddir"
    with torch.cuda.device(x.device):
        err = getattr(library(), f"{name}_{sfx}")(
            x.data_ptr(), raw.data_ptr(), gy.data_ptr(), gld.data_ptr(),
            gx.data_ptr(), graw.data_ptr(), x.numel(), raw.stride(0),
            raw.stride(1), graw.stride(0), graw.stride(1), graw.shape[1],
            int(plan.staged), plan.rows, plan.stride, K, B,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    launches.count(launches.name_of(name, sfx))
    return gx, graw


def _vjp(x, raw, gy, gld, B, K, inverse, use_kernel):
    """The closed-form VJP at x (N,) and raw (N, P ≥ 3K−1): K2/K3, or
    their plain versions; the pad columns get a zero cotangent."""
    if use_kernel:
        return _launch_bwd(x, raw, gy, gld, B, K, inverse)
    tile = tile_bwd_analytic_inverse if inverse else tile_bwd_analytic
    P = 3 * K - 1
    gx, graw = tile(x, raw[:, :P], gy, gld, B)
    if raw.shape[1] > P:
        graw = torch.cat([graw, graw.new_zeros(
            (graw.shape[0], raw.shape[1] - P))], dim=1)
    return gx, graw


class _RQSFused(torch.autograd.Function):
    """x (N,) contiguous, raw (N, P ≥ 3K−1) any strides, the spline's
    parameters in its first 3K−1 columns → (out, ld). Saves (x, raw) and
    recomputes the tables in the backward, as the Pallas custom VJP does
    (`_rqs_fused_t_fwd`); the pad columns get a zero cotangent."""

    @staticmethod
    def forward(ctx, x, raw, B, K, inverse, use_kernel):
        ctx.save_for_backward(x, raw)
        ctx.B, ctx.K, ctx.inverse, ctx.use_kernel = B, K, inverse, use_kernel
        if use_kernel:
            return _launch_fwd(x, raw, B, K, inverse)
        return tile_transform(x, raw[:, :3 * K - 1], B, inverse)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gld):
        x, raw = ctx.saved_tensors
        gx, graw = _vjp(x, raw, gy, gld, ctx.B, ctx.K, ctx.inverse,
                        ctx.use_kernel)
        need_x, need_raw = ctx.needs_input_grad[:2]
        return (gx if need_x else None, graw if need_raw else None,
                None, None, None, None)


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


def _apply(x, raw2, B, K, inverse, backend):
    """x (...,) and raw2 (x.numel(), P ≥ 3K−1) through the Function."""
    use_kernel = _use_kernel(backend, x)
    raw2 = raw2.to(raw_dtype_for(x.dtype, raw2.dtype))
    y, ld = _RQSFused.apply(x.reshape(-1).contiguous(), raw2, float(B),
                            int(K), bool(inverse), use_kernel)
    return y.reshape(x.shape), ld.reshape(x.shape)


def rqs_fused(x, raw, B: float, inverse: bool = False, backend: str = "auto"):
    """Fused RQS transform of ``x`` (...,) by per-element raw parameters
    ``raw`` (..., 3K−1), read through its strides (a param-major
    ``raw_t`` (3K−1, N) goes in as the view ``raw_t.T``). Returns (out,
    elementwise log|d out/d x|), both shaped like and in the dtype of ``x``.
    ``raw`` keeps its dtype where the kernels take it beside x's
    (`KERNEL_TYPES`: bfloat16 raw beside a float32 or bfloat16 x), else
    it is cast to x's; its gradient comes back in its own."""
    P = raw.shape[-1]
    if (P + 1) % 3 or raw.shape[:-1] != x.shape:
        raise ValueError(f"raw must be x.shape + (3K−1,), got "
                         f"{tuple(raw.shape)} for x {tuple(x.shape)}")
    # a view for the conditioner's output
    return _apply(x, raw.reshape(-1, P), B, (P + 1) // 3, inverse, backend)


def rqs_fused_vjp(x, raw, gy, gld, B: float, inverse: bool = False,
                  backend: str = "auto"):
    """The VJP of `rqs_fused` at (x, raw) for the cotangents ``gy`` and
    ``gld`` of its two outputs (each shaped like ``x``): (gx, graw), shaped
    like x and raw. It runs K2 (K3 for ``inverse``) once for CUDA tensors,
    as `rqs_fused`'s backward does, and never the forward: the selective
    remat of `models.spline.SplinePairStack` calls it on a coupling's
    saved input and its recomputed raw."""
    P = raw.shape[-1]
    if (P + 1) % 3 or raw.shape[:-1] != x.shape:
        raise ValueError(f"raw must be x.shape + (3K−1,), got "
                         f"{tuple(raw.shape)} for x {tuple(x.shape)}")
    raw2 = raw.reshape(-1, P)
    raw2 = raw2.to(raw_dtype_for(x.dtype, raw2.dtype))
    gx, graw = _vjp(x.reshape(-1).contiguous(), raw2, gy.reshape(-1),
                    gld.reshape(-1), float(B), (P + 1) // 3, bool(inverse),
                    _use_kernel(backend, x))
    return gx.reshape(x.shape), graw.reshape(raw.shape).to(raw.dtype)


def rqs_fused_t(x_flat, raw_t, B: float, inverse: bool = False,
                backend: str = "auto"):
    """Fused RQS on param-major inputs (JAX `rqs_fused_t`): ``x_flat``
    (N,), ``raw_t`` (3K−1, N). The kernels read ``raw_t`` through its
    strides and its gradient comes back param-major: no transpose."""
    P = raw_t.shape[0]
    if x_flat.dim() != 1 or raw_t.dim() != 2 or (P + 1) % 3 or \
            raw_t.shape[1] != x_flat.shape[0]:
        raise ValueError(f"need x_flat (N,) and raw_t (3K−1, N), got "
                         f"{tuple(x_flat.shape)} and {tuple(raw_t.shape)}")
    return _apply(x_flat, raw_t.T, B, (P + 1) // 3, inverse, backend)


def rqs_fused_e(x_flat, raw_e, B: float, K: int, inverse: bool = False,
                backend: str = "auto"):
    """Fused RQS on elem-major inputs (JAX `rqs_fused_e`): ``x_flat``
    (N,), ``raw_e`` (N, P) with the 3K−1 raw parameters in its leading
    columns. P ≥ 3K−1 may be padded: the pad columns are never read and
    their gradient is exactly 0."""
    K = int(K)
    if x_flat.dim() != 1 or raw_e.dim() != 2 or \
            raw_e.shape[0] != x_flat.shape[0] or raw_e.shape[1] < 3 * K - 1:
        raise ValueError(f"need x_flat (N,) and raw_e (N, P >= 3K−1), got "
                         f"{tuple(x_flat.shape)} and {tuple(raw_e.shape)} "
                         f"for K={K}")
    return _apply(x_flat, raw_e, B, K, inverse, backend)


def rqs_fused_forward(x, raw, B: float, **kw):
    return rqs_fused(x, raw, B, inverse=False, **kw)


def rqs_fused_inverse(y, raw, B: float, **kw):
    return rqs_fused(y, raw, B, inverse=True, **kw)
