"""The port's RealNVP (`realnvp`), fused (`FusedRealNVP`, the coupling
kernels K4/K5) or not, as the configuration's ``fused`` says."""

from __future__ import annotations

import torch

from . import program


def build(cfg: dict, weights: dict, device):
    nft = program()
    flow = nft.realnvp(torch.Generator(device=device).manual_seed(0),
                       cfg["dim"], hdims=tuple(cfg["hidden_dims"]),
                       nlayers=cfg["nlayers"], device=device,
                       fused=cfg["fused"])
    with torch.no_grad():
        for name, (p, i) in _slots(flow).items():
            (p if i is None else p[i]).copy_(weights[name])
    return flow


def _slots(flow) -> dict:
    """{canonical name: (the program's parameter, the block it holds at
    its leading index, or None)}."""
    bij = flow.bijector.bijectors[0]
    out = {}
    if hasattr(bij, "groups"):                      # FusedRealNVP
        n_blocks = bij.groups["even"]["s"][0][0].shape[0]
        for par, grp in enumerate(("even", "odd")):
            for net in ("s", "t"):
                for li, (W, b) in enumerate(bij.groups[grp][net]):
                    for i in range(n_blocks):
                        c = 2 * i + par
                        out[f"c{c}.{net}.l{li}.W"] = (W, i)
                        out[f"c{c}.{net}.l{li}.b"] = (b, i)
        return out
    for par, grp in enumerate(("even", "odd")):      # CouplingPairStack
        for net in ("s", "t"):
            for i, mlp in enumerate(bij.stacked[f"{net}_{grp}"]):
                for li, layer in enumerate(mlp.layers):
                    c = 2 * i + par
                    out[f"c{c}.{net}.l{li}.W"] = (layer.W, None)
                    out[f"c{c}.{net}.l{li}.b"] = (layer.b, None)
    return out


def canonical(flow, of) -> dict:
    out = {}
    for name, (p, i) in _slots(flow).items():
        t = of(p)
        out[name] = t if i is None else t[i]
    return out
