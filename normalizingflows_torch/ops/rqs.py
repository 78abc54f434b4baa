"""Rational-quadratic spline (RQS) transform: the plain PyTorch oracle.

Counterpart of `normalizingflows/jl_tpu/ops/rqs.py`: parameter
normalisation (`rqs_params_from_raw`), forward (`rqs_forward`) and inverse
(`rqs_inverse`) evaluation of the monotone rational-quadratic spline of
Durkan, Bekasov, Murray & Papamakarios, "Neural Spline Flows" (NeurIPS
2019), eqs. (4)-(8). Straight-line tensor code that autograd
differentiates exactly; the fused CUDA kernel in `rqs_cuda.py` is held
against it.

Shapes: the spline is elementwise over an arbitrary batch of scalars with
per-element knot tables. ``x``: (...,); ``xs``/``ys``/``ds``: (..., K+1).
Outside the box [-B, B] the transform is the identity with zero log-det.
"""

from __future__ import annotations

import torch

__all__ = ["rqs_params_from_raw", "rqs_forward", "rqs_inverse"]

# Durkan et al. reference implementation constants (nflows defaults).
DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _exact_cumsum(a: torch.Tensor) -> torch.Tensor:
    """Running sum over the last (K-sized) axis, one add per step, left to
    right: the summation order of the fused kernel."""
    cols = [a[..., :1]]
    for j in range(1, a.shape[-1]):
        cols.append(cols[-1] + a[..., j:j + 1])
    return torch.cat(cols, dim=-1)


def _exact_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the same order, keeping the axis."""
    acc = a[..., :1]
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., j:j + 1]
    return acc


def softplus(z: torch.Tensor) -> torch.Tensor:
    """Stable softplus ``max(z, 0) + log1p(exp(-|z|))``: the form of
    `jax.nn.softplus`, without `torch.nn.functional.softplus`'s linear
    cut-over above 20."""
    return torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-z.abs()))


def softmax(z: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with max subtraction and a division by
    the sum, as `jax.nn.softmax` computes it; the sum is `_exact_sum`."""
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    return e / _exact_sum(e)


def rqs_params_from_raw(
    raw: torch.Tensor,
    B: float,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
):
    """Normalise raw conditioner outputs ``raw`` (..., 3K−1) — K widths, K
    heights, K−1 interior derivatives — into knot tables ``(xs, ys, ds)``,
    each (..., K+1): softmax widths/heights scaled to [−B, B] and summed into
    knot grids pinned at ±B; softplus interior derivatives; boundary
    derivatives 1."""
    K = (raw.shape[-1] + 1) // 3
    w_raw, h_raw, d_raw = raw[..., :K], raw[..., K:2 * K], raw[..., 2 * K:]

    widths = min_bin_width + (1.0 - min_bin_width * K) * softmax(w_raw)
    heights = min_bin_height + (1.0 - min_bin_height * K) * softmax(h_raw)

    def knots(bins):
        inner = -B + (2.0 * B) * _exact_cumsum(bins)
        lo = torch.full_like(inner[..., :1], -B)
        hi = torch.full_like(inner[..., :1], B)
        return torch.cat([lo, inner[..., :-1], hi], dim=-1)

    interior = min_derivative + softplus(d_raw)
    one = torch.ones_like(interior[..., :1])
    return knots(widths), knots(heights), torch.cat([one, interior, one], -1)


def _select_bin(v: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """Index of the bin holding v: #{k : knots[k] <= v} − 1, clipped to
    [0, K−1] (broadcast compare and sum, no search)."""
    K = knots.shape[-1] - 1
    k = (v[..., None] >= knots[..., :-1]).sum(dim=-1) - 1
    return k.clamp(0, K - 1)


def _gather(params: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.gather(params, -1, k[..., None])[..., 0]


def _bin(v, xs, ys, ds, grid):
    k = _select_bin(v, grid)
    x_k, x_k1 = _gather(xs, k), _gather(xs, k + 1)
    y_k, y_k1 = _gather(ys, k), _gather(ys, k + 1)
    d_k, d_k1 = _gather(ds, k), _gather(ds, k + 1)
    tiny = 1e-6 * (xs[..., -1] - xs[..., 0])
    w = torch.maximum(x_k1 - x_k, tiny)
    h = torch.maximum(y_k1 - y_k, tiny)
    return x_k, y_k, d_k, d_k1, w, h


def _log_deriv(s, d_k, d_k1, xi):
    """log dy/dx of eq. (5) at ξ, and the denominator it shares with y."""
    xi1m = 1.0 - xi
    xi_prod = xi * xi1m
    denom = s + (d_k1 + d_k - 2.0 * s) * xi_prod
    deriv_num = s.square() * (
        d_k1 * xi.square() + 2.0 * s * xi_prod + d_k * xi1m.square())
    return torch.log(deriv_num) - 2.0 * torch.log(denom), denom, xi_prod


def rqs_forward(x, xs, ys, ds):
    """Elementwise forward RQS: (y, log|dy/dx|). Durkan et al. eq. (4) for
    the value and the log of eq. (5); identity with log-det 0 outside."""
    B = xs[..., -1]
    inside = (x >= -B) & (x <= B)
    xc = torch.minimum(torch.maximum(x, -B), B)
    x_k, y_k, d_k, d_k1, w, h = _bin(xc, xs, ys, ds, xs)
    s = h / w
    xi = (xc - x_k) / w
    log_det, denom, xi_prod = _log_deriv(s, d_k, d_k1, xi)
    y = y_k + h * (s * xi.square() + d_k * xi_prod) / denom
    y = torch.where(inside, y, x)
    return y, torch.where(inside, log_det, torch.zeros_like(log_det))


def rqs_inverse(y, xs, ys, ds):
    """Elementwise inverse RQS: (x, −log|dy/dx| at x). Durkan et al. eqs.
    (6)-(8), with the stable root ``2c / (−b − √(b²−4ac))``."""
    B = ys[..., -1]
    inside = (y >= -B) & (y <= B)
    yc = torch.minimum(torch.maximum(y, -B), B)
    x_k, y_k, d_k, d_k1, w, h = _bin(yc, xs, ys, ds, ys)
    s = h / w
    dy = yc - y_k
    dsum = d_k1 + d_k - 2.0 * s
    a = h * (s - d_k) + dy * dsum
    b = h * d_k - dy * dsum
    c = -s * dy
    disc = torch.clamp_min(b.square() - 4.0 * a * c, 0.0)
    xi = (2.0 * c / (-b - torch.sqrt(disc))).clamp(0.0, 1.0)
    x = x_k + xi * w
    log_det = -_log_deriv(s, d_k, d_k1, xi)[0]
    x = torch.where(inside, x, y)
    return x, torch.where(inside, log_det, torch.zeros_like(log_det))
