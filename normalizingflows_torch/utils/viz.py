"""Visualization utilities for flows and 2-D synthetic targets.

Counterpart of `normalizingflows/jl_tpu/utils/viz.py` (reference
`example/utils.jl:5-58`: `compare_trained_and_untrained_flow` scatter
overlay; `example/SyntheticTargets.jl:12-19`: `visualize` pdf contour +
samples), with the same groups, labels, colours, grid and defaults.
Matplotlib (Agg, headless) is imported inside the functions, never when this
module is imported: where it is missing (the card's machine) a call raises
ImportError and nothing else is affected. Figures are returned and
optionally saved, never shown.

Sampling and densities run under `torch.no_grad` on the distribution's
device; only the (n, 2) arrays and the density grid go to the host.
Where the JAX functions take a PRNG ``key`` these take a
``torch.Generator`` on the flow's device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["compare_trained_and_untrained_flow", "visualize", "plot_losses"]


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _draw(dist, generator: torch.Generator, n_samples: int) -> np.ndarray:
    with torch.no_grad():
        return dist.sample(generator, (n_samples,)).cpu().numpy()


def _placement(target, generator: torch.Generator | None):
    """Device and dtype of a target's log-density on the grid: its
    buffers' (a `GaussianMixture`'s), else the generator's device (the
    CPU without one) in float64."""
    t = next(target.buffers(), None)
    if t is not None:
        return t.device, t.dtype
    return (generator.device if generator is not None
            else torch.device("cpu")), torch.float64


def density_grid(target, grid_lims: tuple[float, float, float, float],
                 grid_res: int = 200, device=None, dtype=torch.float64):
    """``(xx, yy, p)``: the (grid_res, grid_res) mesh over ``grid_lims``
    (x0, x1, y0, y1) and ``exp(target.log_prob)`` on it, the grid
    `visualize` draws."""
    xg = np.linspace(grid_lims[0], grid_lims[1], grid_res)
    yg = np.linspace(grid_lims[2], grid_lims[3], grid_res)
    xx, yy = np.meshgrid(xg, yg)
    pts = torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], axis=-1),
                          dtype=dtype, device=device)
    with torch.no_grad():
        logp = target.log_prob(pts).double().cpu().numpy()
    return xx, yy, np.exp(logp.reshape(xx.shape))


def compare_trained_and_untrained_flow(
    flow_trained,
    flow_untrained,
    target,
    generator: torch.Generator,
    n_samples: int = 1000,
    dims: Sequence[int] = (0, 1),
    save_to: str | None = None,
):
    """Scatter overlay of trained-flow, untrained-flow, and target samples.

    Mirrors `compare_trained_and_untrained_flow` at `example/utils.jl:5-46`
    (same three groups and default sample count), each group drawn in turn
    from ``generator``. ``dims`` picks the two coordinates to plot for
    d > 2. Returns the matplotlib figure.
    """
    plt = _mpl()
    groups = [
        (_draw(flow_trained, generator, n_samples), "trained flow",
         "tab:blue", 0.5),
        (_draw(flow_untrained, generator, n_samples), "untrained flow",
         "tab:orange", 0.3),
        (_draw(target, generator, n_samples), "target", "tab:green", 0.5),
    ]
    i, j = dims
    fig, ax = plt.subplots(figsize=(6, 6))
    for samples, label, color, alpha in groups:
        ax.scatter(samples[:, i], samples[:, j], s=6, alpha=alpha,
                   color=color, label=label, linewidths=0)
    ax.set_xlabel(f"x[{i}]")
    ax.set_ylabel(f"x[{j}]")
    ax.legend(loc="best")
    ax.set_title("trained vs untrained flow vs target")
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=120)
    return fig


def visualize(
    target,
    samples: np.ndarray | torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    n_samples: int = 1000,
    grid_lims: tuple[float, float, float, float] | None = None,
    grid_res: int = 200,
    save_to: str | None = None,
):
    """Density contour of a 2-D target with samples overlaid.

    Mirrors `visualize(p, samples)` at `example/SyntheticTargets.jl:12-19`
    (pdf contour + scatter). ``samples`` defaults to draws from the target
    (``generator`` defaults to a CPU generator of seed 0, as JAX's key 0);
    ``grid_lims`` (x0, x1, y0, y1) defaults to the sample bounding box
    padded 10%. Returns the matplotlib figure.
    """
    plt = _mpl()
    if samples is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        samples = _draw(target, generator, n_samples)
    if torch.is_tensor(samples):
        samples = samples.detach().cpu().numpy()
    samples = np.asarray(samples)

    if grid_lims is None:
        lo = samples.min(axis=0)
        hi = samples.max(axis=0)
        pad = 0.1 * (hi - lo)
        grid_lims = (lo[0] - pad[0], hi[0] + pad[0],
                     lo[1] - pad[1], hi[1] + pad[1])
    xx, yy, p = density_grid(target, grid_lims, grid_res,
                             *_placement(target, generator))

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.contourf(xx, yy, p, levels=30, cmap="viridis")
    ax.scatter(samples[:, 0], samples[:, 1], s=4, alpha=0.4, color="white",
               linewidths=0)
    ax.set_xlabel("x[0]")
    ax.set_ylabel("x[1]")
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=120)
    return fig


def plot_losses(stats: dict, save_to: str | None = None):
    """Training-loss curve from `TrainResult.stats` (the reference demos
    plot `map(x -> x.loss, stats)`, `example/demo_planar_flow.jl:50-55`)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(np.asarray(stats["iteration"]), np.asarray(stats["loss"]),
            lw=0.8)
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss (−objective)")
    ax.set_yscale("symlog")
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=120)
    return fig
