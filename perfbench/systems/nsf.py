"""The port's neural spline flow (`nsf`, one `SplinePairStack`)."""

from __future__ import annotations

import torch

from . import program


def build(cfg: dict, weights: dict, device):
    nft = program()
    flow = nft.nsf(torch.Generator(device=device).manual_seed(0), cfg["dim"],
                   hdims=tuple(cfg["hidden_dims"]), K=cfg["K"], B=cfg["B"],
                   nlayers=cfg["nlayers"], device=device)
    with torch.no_grad():
        for name, p in params(flow).items():
            p.copy_(weights[name])
    return flow


def params(flow) -> dict:
    """{canonical name: the program's parameter}."""
    stack = flow.bijector.bijectors[0]
    out = {}
    for i, (even, odd) in enumerate(zip(stack.stacked["even"],
                                        stack.stacked["odd"])):
        for c, net in ((2 * i, even), (2 * i + 1, odd)):
            for li, layer in enumerate(net.layers):
                out[f"c{c}.l{li}.W"] = layer.W
                out[f"c{c}.l{li}.b"] = layer.b
    return out


def canonical(flow, of) -> dict:
    """{canonical name: of(parameter)}."""
    return {k: of(p) for k, p in params(flow).items()}
