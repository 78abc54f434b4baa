"""Plain reference of RealNVP (Dinh, Sohl-Dickstein & Bengio 2017) in the
layout of NormalizingFlows.jl `src/flows/realnvp.jl`: ``nlayers`` blocks
of two affine couplings with alternating masks. The even coupling maps
x[0::2] to x[0::2] * exp(s(x[1::2])) + t(x[1::2]), then the odd one
x[1::2] from the new x[0::2]; log|det J| adds the sum of s. The scale net
s ends in tanh, the shift net t in no activation.

Canonical weights: ``c{c}.{s|t}.l{l}.W`` (in, out) and ``...b`` for
coupling c = 2 * block + (0 even, 1 odd).
"""

from __future__ import annotations

import torch

from .nets import dense_leaves, interleave, mlp, split_sizes


def n_transformed(cfg: dict) -> list[int]:
    even, odd = split_sizes(cfg["dim"])
    return [even, odd] * cfg["nlayers"]


def conditioner_widths(cfg: dict, c: int) -> list[int]:
    n_t = n_transformed(cfg)[c]
    return [cfg["dim"] - n_t, *cfg["hidden_dims"], n_t]


def leaves(cfg: dict) -> list:
    k = cfg.get("last_layer_scale", 1.0)
    return [leaf for c in range(2 * cfg["nlayers"]) for net in ("s", "t")
            for leaf in dense_leaves(f"c{c}.{net}",
                                     conditioner_widths(cfg, c), k)]


def forward_and_log_det(weights: dict, x: torch.Tensor, cfg: dict,
                        precision: str):
    """(y, log|det J|) of the flow at base draws x (n, d)."""
    depth = len(cfg["hidden_dims"]) + 1
    xa, xb = x[..., 0::2], x[..., 1::2]
    ld = x.new_zeros(x.shape[:-1])

    def coupling(c, v, cond):
        s = mlp(weights, f"c{c}.s", cond, depth, precision, torch.tanh)
        t = mlp(weights, f"c{c}.t", cond, depth, precision)
        return v * torch.exp(s) + t, s.sum(dim=-1)

    for i in range(cfg["nlayers"]):
        xa, ld_a = coupling(2 * i, xa, xb)
        xb, ld_b = coupling(2 * i + 1, xb, xa)
        ld = ld + ld_a + ld_b
    return interleave(xa, xb), ld
