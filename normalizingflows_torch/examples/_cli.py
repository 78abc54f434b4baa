"""What the demos share: their command line and their optional plots."""

from __future__ import annotations

import argparse
import copy
from pathlib import Path

import torch

from ..utils.device import resolve_device


def parser(doc: str, iters: int) -> argparse.ArgumentParser:
    """The demos' command line: ``--iters``, ``--device`` (default: the
    card) and ``--plot PATH``."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--iters", type=int, default=iters)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--plot", default=None, metavar="PATH",
                   help="write the trained/untrained/target overlay to PATH "
                        "and the loss curve beside it (needs matplotlib)")
    return p


def generators(seed: int, device) -> tuple[torch.Generator, torch.Generator]:
    """(init, train): the construction generator on the host and the
    training generator on ``device``, from one seed, as the JAX demos split
    their key into an init and a training key."""
    device = resolve_device(device)
    return (torch.Generator().manual_seed(seed),
            torch.Generator(device=device).manual_seed(seed + 1))


def untrained(flow, plot):
    """A copy of ``flow`` before training, kept only if a plot wants it."""
    return copy.deepcopy(flow) if plot else None


def plot(path, trained, before, target, stats, device):
    """The overlay of trained flow, untrained flow and target at ``path``,
    and the loss curve at ``<stem>_loss<suffix>``."""
    from ..utils import viz

    gen = torch.Generator(device=resolve_device(device)).manual_seed(0)
    viz.compare_trained_and_untrained_flow(trained, before, target, gen,
                                           save_to=str(path))
    p = Path(path)
    viz.plot_losses(stats, save_to=str(p.with_name(f"{p.stem}_loss"
                                                   f"{p.suffix}")))
