"""Training API: `train_flow` / `train_flow_mle` / `optimize`.

Counterpart of `normalizingflows/jl_tpu/train.py` (reference
`src/NormalizingFlows.jl:51-86` driving `src/optimize.jl:57-108`). One step
is: objective → loss = −objective → backward → gradient norm → optimizer
step. Steps run in chunks of ``check_every``; per-step loss and gradient
norm stay on the device and are fetched once per chunk, where the host does
the bookkeeping the reference does every iteration (stats, callback,
convergence predicate, progress line), as the JAX package does at its scan
chunk boundaries.

The flow is trained in place: `TrainResult.flow` is the module passed in.
`TrainState.opt_state` is the optimizer itself, which holds the moments.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .models.distributions import TransformedDistribution
from .utils.pytree import global_norm, trainable_parameters

__all__ = ["train_flow", "train_flow_mle", "optimize", "TrainResult",
           "TrainState"]

OptimizerFactory = Callable[[list], torch.optim.Optimizer]


class TrainState(NamedTuple):
    """Resumable state (the reference returns its opt-state "for potential
    continuation of training", `src/optimize.jl:106-107`)."""

    flow: TransformedDistribution
    opt_state: torch.optim.Optimizer
    iteration: int


class TrainResult(NamedTuple):
    flow: TransformedDistribution
    stats: dict  # {"iteration", "loss", "gradient_norm", ...} 1-D arrays
    state: TrainState


def _default_optimizer(params) -> torch.optim.Optimizer:
    # Reference default: Optimisers.ADAM() == Adam(lr=1e-3)
    # (`src/NormalizingFlows.jl:60`). torch's Adam with betas (0.9, 0.999)
    # and eps 1e-8 is optax.adam's update.
    return torch.optim.Adam(params, lr=1e-3)


def _start(flow, optimizer, train_base, resume_state):
    """(flow, optimizer, first iteration, trainable parameters): a fresh
    optimizer over the trainable parameters, or the resumed run's."""
    if resume_state is not None:
        flow = resume_state.flow
        return (flow, resume_state.opt_state, resume_state.iteration,
                trainable_parameters(flow, train_base))
    params = trainable_parameters(flow, train_base)
    return flow, (optimizer or _default_optimizer)(params), 0, params


def _drive_chunks(run_chunk, flow, opt, start_iter, max_iters, check_every,
                  callback, hasconverged, show_progress, label) -> TrainResult:
    """Host-side chunk driver: ``run_chunk(chunk)`` runs ``chunk`` steps and
    returns their losses and gradient norms as device tensors; then the
    chunk-boundary bookkeeping of the reference (`src/optimize.jl:85-105`)."""
    all_loss: list[np.ndarray] = []
    all_gnorm: list[np.ndarray] = []
    extra: dict[str, list] = {}
    it = start_iter
    converged = False
    t0 = time.perf_counter()

    while it < start_iter + max_iters and not converged:
        chunk = min(check_every, start_iter + max_iters - it)
        losses, gnorms = run_chunk(chunk)
        losses = losses.cpu().numpy()   # one device→host fetch per chunk
        gnorms = gnorms.cpu().numpy()
        all_loss.append(losses)
        all_gnorm.append(gnorms)
        it += chunk

        stat = {"iteration": it, "loss": float(losses[-1]),
                "gradient_norm": float(gnorms[-1])}
        if callback is not None:
            merged = callback(it, stat, flow)
            if merged:
                stat.update(merged)
                for k, v in merged.items():
                    extra.setdefault(k, []).append(v)
        if hasconverged is not None:
            converged = bool(hasconverged(it, stat, flow, opt))
        if show_progress:
            rate = (it - start_iter) / max(time.perf_counter() - t0, 1e-9)
            print(f"[{label}] iter {it:>7d}  loss {stat['loss']:+.6f}  "
                  f"|g| {stat['gradient_norm']:.3e}  ({rate:.1f} it/s)",
                  flush=True)

    loss_arr = np.concatenate(all_loss) if all_loss else np.zeros((0,))
    gnorm_arr = np.concatenate(all_gnorm) if all_gnorm else np.zeros((0,))
    stats = {
        "iteration": np.arange(start_iter + 1, start_iter + 1 + len(loss_arr)),
        "loss": loss_arr,
        "gradient_norm": gnorm_arr,
    }
    for k, v in extra.items():
        stats[k] = np.asarray(v)
    return TrainResult(flow, stats, TrainState(flow, opt, it))


def train_flow(
    generator: torch.Generator,
    objective: Callable[..., torch.Tensor],
    flow: TransformedDistribution,
    *args: Any,
    max_iters: int = 1000,
    optimizer: OptimizerFactory | None = None,
    train_base: bool = False,
    callback: Callable[[int, dict, TransformedDistribution], dict | None]
    | None = None,
    hasconverged: Callable[[int, dict, TransformedDistribution, Any], bool]
    | None = None,
    show_progress: bool = False,
    check_every: int = 100,
    resume_state: TrainState | None = None,
    scan_inputs: Callable[[torch.Generator, TransformedDistribution, int],
                          Any] | None = None,
) -> TrainResult:
    """Train ``flow`` by maximising ``objective(input, flow, *args)``.

    The loss is the negated objective; per-step stats are ``(iteration,
    loss, gradient_norm)``; ``callback(i, stats, flow)`` may return a dict
    merged into the stats and ``hasconverged(i, stats, flow, opt_state)``
    stops the loop. Both run every ``check_every`` steps (chunk boundary).

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer`` (default
    Adam(lr=1e-3)). ``train_base=False`` freezes ``flow.base``.
    ``scan_inputs(generator, flow, chunk)`` gives the chunk's per-step
    inputs (indexable by step); by default every step gets ``generator``.
    Pass `objectives.presample_base(n)` with the `elbo_from_samples`
    objective to draw a whole chunk's base samples in one call.
    """
    flow, opt, start_iter, params = _start(flow, optimizer, train_base,
                                           resume_state)
    if scan_inputs is None:
        def scan_inputs(g, f, n):
            return [g] * n

    def run_chunk(chunk):
        inputs = scan_inputs(generator, flow, chunk)
        losses, gnorms = [], []
        for i in range(chunk):
            opt.zero_grad(set_to_none=True)
            loss = -objective(inputs[i], flow, *args)
            loss.backward()
            gnorms.append(global_norm([p.grad for p in params]))
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses), torch.stack(gnorms)

    return _drive_chunks(run_chunk, flow, opt, start_iter, max_iters,
                         check_every, callback, hasconverged, show_progress,
                         "train_flow")


def train_flow_mle(
    flow: TransformedDistribution,
    loader,
    max_iters: int = 1000,
    optimizer: OptimizerFactory | None = None,
    train_base: bool = False,
    check_every: int = 100,
    show_progress: bool = False,
    callback: Callable[[int, dict, TransformedDistribution], dict | None]
    | None = None,
    hasconverged: Callable[[int, dict, TransformedDistribution, Any], bool]
    | None = None,
    resume_state: TrainState | None = None,
) -> TrainResult:
    """Forward-KL (maximum-likelihood) training from a data loader.

    ``loader`` is any object with ``next_batches(k) -> (k, batch, dim)``
    (`utils.data.make_loader`). Per chunk of ``check_every`` steps the
    chunk's batches are fetched once and moved to the flow's device and
    dtype in one copy; each step maximises `objectives.loglikelihood` of
    its batch, the density path (inverse with log-det). `_drive_chunks`,
    stats, callback and convergence check are `train_flow`'s.
    ``train_base=False`` freezes ``flow.base``.
    """
    from .objectives import loglikelihood

    flow, opt, start_iter, params = _start(flow, optimizer, train_base,
                                           resume_state)
    like = next(flow.parameters())

    def run_chunk(chunk):
        batches = torch.from_numpy(np.asarray(loader.next_batches(chunk))).to(
            device=like.device, dtype=like.dtype)
        losses, gnorms = [], []
        for i in range(chunk):
            opt.zero_grad(set_to_none=True)
            loss = -loglikelihood(flow, batches[i])
            loss.backward()
            gnorms.append(global_norm([p.grad for p in params]))
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses), torch.stack(gnorms)

    return _drive_chunks(run_chunk, flow, opt, start_iter, max_iters,
                         check_every, callback, hasconverged, show_progress,
                         "train_flow_mle")


def optimize(
    generator: torch.Generator,
    loss: Callable[..., torch.Tensor],
    params: torch.nn.Module,
    *args: Any,
    max_iters: int = 10_000,
    optimizer: OptimizerFactory | None = None,
    **kwargs: Any,
) -> TrainResult:
    """Minimise ``loss(input, params, *args)`` over a module's parameters
    (all of them) — the standalone analogue of `optimize` at
    `src/optimize.jl:57-108`. Takes the same kwargs as `train_flow`."""
    return train_flow(
        generator, lambda g, p, *a: -loss(g, p, *a), params, *args,
        max_iters=max_iters, optimizer=optimizer, train_base=True, **kwargs)
