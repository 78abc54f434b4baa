"""A configuration's weights, made from the seed on the device in one
draw: every leaf of the reference's canonical layout, uniform in ±its
scale. The program is given a copy; the reference draws them again."""

from __future__ import annotations

import math

import torch


def draw(leaves, generator: torch.Generator, device) -> dict:
    """{name: float32 tensor} for ``leaves`` [(name, shape, scale)]."""
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.rand(sum(sizes), generator=generator, device=device)
    flat.mul_(2).sub_(1)
    out, at = {}, 0
    for (name, shape, scale), n in zip(leaves, sizes):
        out[name] = flat[at:at + n].view(shape).mul_(scale)
        at += n
    return out


def generator(seed: int, device) -> torch.Generator:
    """The run's generator: the weights come first from it, then every
    base draw. Any whole number is a seed."""
    return torch.Generator(device=device).manual_seed(seed % 2 ** 64)
