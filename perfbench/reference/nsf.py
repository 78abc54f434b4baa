"""Plain reference of the neural spline flow (Durkan, Bekasov, Murray &
Papamakarios, "Neural Spline Flows", NeurIPS 2019, eqs. 4-5), in the
layout of NormalizingFlows.jl `src/flows/neuralspline.jl`: ``nlayers``
blocks of two rational-quadratic couplings with alternating masks. The
even coupling transforms x[0::2] from a conditioner of x[1::2], then the
odd one x[1::2] from the new x[0::2]. A conditioner maps its input
through Dense layers to (3K - 1) raw parameters per transformed dimension:
K bin widths, K bin heights and K - 1 interior derivatives, normalised as
nflows does (softmax bins with a 1e-3 floor scaled onto [-B, B], softplus
derivatives with a 1e-3 floor, derivative 1 at the box's ends). Outside
[-B, B] a coupling is the identity with log-det 0.

Canonical weights: ``c{c}.l{l}.W`` (in, out) and ``c{c}.l{l}.b`` for
coupling c = 2 * block + (0 even, 1 odd) and Dense layer l.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nets import dense_leaves, interleave, mlp, split_sizes

MIN_BIN_WIDTH = MIN_BIN_HEIGHT = MIN_DERIVATIVE = 1e-3


def n_transformed(cfg: dict) -> list[int]:
    """Dimensions each coupling transforms, in the order they run."""
    even, odd = split_sizes(cfg["dim"])
    return [even, odd] * cfg["nlayers"]


def conditioner_widths(cfg: dict, c: int) -> list[int]:
    d, K = cfg["dim"], cfg["K"]
    n_t = n_transformed(cfg)[c]
    return [d - n_t, *cfg["hidden_dims"], (3 * K - 1) * n_t]


def leaves(cfg: dict) -> list:
    """The canonical weights; the configuration's ``last_layer_scale``
    scales each conditioner's raw output (`nets.dense_leaves`)."""
    k = cfg.get("last_layer_scale", 1.0)
    return [leaf for c in range(2 * cfg["nlayers"])
            for leaf in dense_leaves(f"c{c}", conditioner_widths(cfg, c), k)]


def _knots(bins: torch.Tensor, B: float) -> torch.Tensor:
    inner = -B + 2.0 * B * torch.cumsum(bins, dim=-1)[..., :-1]
    lo = torch.full_like(bins[..., :1], -B)
    hi = torch.full_like(bins[..., :1], B)
    return torch.cat([lo, inner, hi], dim=-1)


def spline(x: torch.Tensor, raw: torch.Tensor, B: float):
    """Elementwise forward rational-quadratic spline: (y, log dy/dx) for
    x (...,) and raw (..., 3K - 1)."""
    K = (raw.shape[-1] + 1) // 3
    w = MIN_BIN_WIDTH + (1 - MIN_BIN_WIDTH * K) * torch.softmax(
        raw[..., :K], dim=-1)
    h = MIN_BIN_HEIGHT + (1 - MIN_BIN_HEIGHT * K) * torch.softmax(
        raw[..., K:2 * K], dim=-1)
    xs, ys = _knots(w, B), _knots(h, B)
    inner = MIN_DERIVATIVE + F.softplus(raw[..., 2 * K:], threshold=1e9)
    one = torch.ones_like(inner[..., :1])
    ds = torch.cat([one, inner, one], dim=-1)

    inside = (x >= -B) & (x <= B)
    xc = x.clamp(-B, B)
    k = (xc[..., None] >= xs[..., 1:-1]).sum(dim=-1, keepdim=True)

    def at(t, j):
        return torch.gather(t, -1, j)[..., 0]

    x_k, y_k = at(xs, k), at(ys, k)
    wk = at(xs, k + 1) - x_k
    hk = at(ys, k + 1) - y_k
    d_k, d_k1 = at(ds, k), at(ds, k + 1)
    s = hk / wk
    xi = (xc - x_k) / wk
    xi1m = 1 - xi
    denom = s + (d_k1 + d_k - 2 * s) * xi * xi1m
    y = y_k + hk * (s * xi ** 2 + d_k * xi * xi1m) / denom
    deriv = s ** 2 * (d_k1 * xi ** 2 + 2 * s * xi * xi1m + d_k * xi1m ** 2) \
        / denom ** 2
    y = torch.where(inside, y, x)
    return y, torch.where(inside, torch.log(deriv), torch.zeros_like(y))


def forward_and_log_det(weights: dict, x: torch.Tensor, cfg: dict,
                        precision: str):
    """(y, log|det J|) of the flow at base draws x (n, d)."""
    K, B, depth = cfg["K"], float(cfg["B"]), len(cfg["hidden_dims"]) + 1
    xa, xb = x[..., 0::2], x[..., 1::2]
    ld = x.new_zeros(x.shape[:-1])

    def coupling(c, v, cond):
        raw = mlp(weights, f"c{c}", cond, depth, precision)
        v, lds = spline(v, raw.reshape(v.shape + (3 * K - 1,)), B)
        return v, lds.sum(dim=-1)

    for i in range(cfg["nlayers"]):
        xa, ld_a = coupling(2 * i, xa, xb)
        xb, ld_b = coupling(2 * i + 1, xb, xa)
        ld = ld + ld_a + ld_b
    return interleave(xa, xb), ld
