"""Whole-run RealNVP ELBO training: the CUDA kernel K6 and its plain version.

Counterpart of `normalizingflows/jl_tpu/experimental/train_pallas.py`.
`adam_train_realnvp_fused` runs a whole reverse-KL training run of a fused
RealNVP stack with Adam in launches of ``chunk`` steps of K6
``realnvp_train`` (``csrc/train.cu``), the port of the Pallas
`_train_kernel`. Per step, on that step's presampled base draws: the stack
forward with its log-det, the target log-density, the negative ELBO
(stored to ``losses``), the hand-written reverse sweep of K5 and the Adam
update, optax.adam's formula (bias-corrected moments, eps outside the
square root) at the global step. Between launches the flat weights and
Adam moments stay in device memory and the step index advances, as the JAX
wrapper threads them between its launches.

The target is a device function, not a callable: K6 evaluates the Banana
log-density and its gradient itself, so ``target`` must be an
`nft.Banana` (or its bound ``log_prob``) of the flow's dimension, whose
``b`` and ``var`` go into the launch as scalars (the JAX kernel's
"Python-scalar closure constants"). Any other target raises.

Beside K6 is its plain version `adam_train_plain`, a transcription of
`_train_kernel` in torch: `tile_flow`, the Banana log-density and its
written-out gradient, `tile_flow_bwd` under those cotangents over the whole
batch, and the same Adam formula. ``backend="auto"`` launches K6 for CUDA
tensors and runs the plain version for CPU tensors; ``"plain"`` always
runs the plain version; ``"cuda"`` raises without CUDA tensors. Nothing
falls back. K6 runs K5's lane tile, its rows fitted to the batch, plus a
word a row for the ELBO terms, so it has a cap on blocks like K5's and
raises before any step runs (`coupling_cuda._kernel_args`).
``TRAIN_LAUNCHES`` counts K6 launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..models.targets import Banana
from .coupling_cuda import (
    _depth,
    _kernel_args,
    _leaves,
    _raise_on,
    _sels,
    _unflatten,
    _use_kernel,
    tile_flow,
    tile_flow_bwd,
)

__all__ = ["adam_train_realnvp_fused", "adam_train_plain", "TRAIN_LAUNCHES"]

_LOG_2PI = 1.8378770664093453

# K6 launches since import (or since a caller reset it to 0).
TRAIN_LAUNCHES = 0


class _Run(NamedTuple):
    """What a run holds fixed: the stack's index sets and depth, the base,
    Adam's constants and the Banana target's."""

    sels: tuple
    depth: int
    loc: torch.Tensor
    scale: torch.Tensor
    lr: float
    b1: float
    b2: float
    eps: float
    bb: float
    var: float
    log_z: float


def _banana(target, d: int) -> Banana:
    """The Banana that ``target`` is (or whose ``log_prob`` it is)."""
    banana = getattr(target, "__self__", target)
    if not isinstance(banana, Banana) or (
            target is not banana and target != banana.log_prob):
        raise ValueError(
            "the whole-run training kernel evaluates the target's "
            "log-density and its gradient itself and takes only "
            "nft.Banana (or its log_prob) as target; the other targets "
            f"are not ported yet: got {target!r}")
    if banana.dim != d:
        raise ValueError(f"Banana of dimension {banana.dim} for a flow of "
                         f"dimension {d}")
    return banana


def _prepare(xs, groups, idx_even, idx_odd, target, base_loc, base_scale,
             lr, b1, b2, eps):
    if xs.dim() != 3:
        raise ValueError(f"xs must be (n_steps, batch, d), got "
                         f"{tuple(xs.shape)}")
    d = xs.shape[-1]
    banana = _banana(target, d)
    base = [torch.broadcast_to(torch.as_tensor(t).detach(), (d,)).to(
        device=xs.device, dtype=xs.dtype).contiguous()
        for t in (base_loc, base_scale)]
    log_z = 0.5 * (d * _LOG_2PI + math.log(banana.var))
    run = _Run(_sels(idx_even, idx_odd, d), _depth(groups), base[0], base[1],
               float(lr), float(b1), float(b2), float(eps), banana.b,
               banana.var, log_z)
    return run, [t.detach() for t in _leaves(groups)]


def _chunks(n_steps: int, chunk: int):
    """(step0, steps) of each launch."""
    return [(s, min(chunk, n_steps - s)) for s in range(0, n_steps, chunk)]


def _split(flat, like):
    """Views of the flat buffer shaped as the leaves ``like``."""
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _loss_and_grads(x, w, run: _Run):
    """The negative ELBO on x (batch, d) and its gradient with respect to
    the leaves w, by `tile_flow` and the manual sweep `tile_flow_bwd` under
    the cotangents of the loss, as `_train_kernel` takes them."""
    batch, d = x.shape
    groups = _unflatten(w, run.depth)
    y, ld = tile_flow(x, groups, run.sels)
    # Banana: z = y₁ + b·y₀² − var·b; ∂log p/∂y₀ = −(y₀/var + 2b·y₀·z),
    # ∂/∂y₁ = −z, ∂/∂y_j = −y_j
    y0, y1, rest = y[:, 0], y[:, 1], y[:, 2:]
    z = y1 + run.bb * (y0 * y0) - run.var * run.bb
    log_p = -run.log_z - 0.5 * ((y0 * y0) / run.var + z * z
                                + (rest * rest).sum(dim=-1))
    zq = (x - run.loc) / run.scale
    log_q0 = (-0.5 * (zq * zq).sum(dim=-1) - torch.log(run.scale).sum()
              - 0.5 * d * _LOG_2PI)
    loss = -(log_p - log_q0 + ld).sum() / batch
    neg_inv_b = -(1.0 / batch)
    dlog_p = torch.cat([(-(y0 / run.var + 2.0 * run.bb * y0 * z))[:, None],
                        (-z)[:, None], -rest], dim=1)
    _, tree = tile_flow_bwd(x, groups, neg_inv_b * dlog_p,
                            x.new_full((batch,), neg_inv_b), run.sels)
    return loss, _leaves(tree)


def _adam(w, m, v, grads, t: int, run: _Run):
    """optax.adam's update at global step t, in place; the bias
    corrections 1 − βᵗ as exp(t·log β), in the weights' dtype."""
    tt = w[0].new_full((), float(t))
    c1 = 1.0 - torch.exp(tt * math.log(run.b1))
    c2 = 1.0 - torch.exp(tt * math.log(run.b2))
    for wi, mi, vi, g in zip(w, m, v, grads):
        mi.copy_(run.b1 * mi + (1.0 - run.b1) * g)
        vi.copy_(run.b2 * vi + (1.0 - run.b2) * g * g)
        wi.copy_(wi - run.lr * ((mi / c1) / (torch.sqrt(vi / c2) + run.eps)))


def _run_plain(xs, leaves, run: _Run):
    """Every step in turn: (trained leaves, losses). The kernel's chunks
    change nothing here, as each step's bias correction takes its global
    index."""
    w = [t.clone() for t in leaves]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    losses = xs.new_empty(xs.shape[0])
    for s in range(xs.shape[0]):
        losses[s], grads = _loss_and_grads(xs[s], w, run)
        _adam(w, m, v, grads, s + 1, run)
    return w, losses


def adam_train_plain(xs, groups, idx_even, idx_odd, target, base_loc,
                     base_scale, lr, b1=0.9, b2=0.999, eps=1e-8):
    """Plain version of K6: the same run in torch ops, the whole batch at
    once. Arguments and result as `adam_train_realnvp_fused`'s, without
    ``chunk``: the run is the same whatever the launches."""
    run, leaves = _prepare(xs, groups, idx_even, idx_odd, target, base_loc,
                           base_scale, lr, b1, b2, eps)
    with torch.no_grad():
        w, losses = _run_plain(xs, leaves, run)
    return _unflatten(w, run.depth), losses


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _launch_chunk(fn, xs, w, m, v, grad, losses, run: _Run, step0: int,
                  steps: int, args) -> None:
    """One K6 launch: steps ``step0 .. step0 + steps − 1`` of the run."""
    global TRAIN_LAUNCHES
    n_steps, batch, d = xs.shape
    widths, idx, n_blocks, hyper = args
    err = fn(xs[step0].data_ptr(), w.data_ptr(), m.data_ptr(), v.data_ptr(),
             grad.data_ptr(), losses[step0].data_ptr(), run.loc.data_ptr(),
             run.scale.data_ptr(), steps, step0, batch, d, n_blocks,
             run.depth, widths, idx, hyper,
             torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "realnvp_train")
    TRAIN_LAUNCHES += 1


def _launch(xs, leaves, run: _Run, chunk: int):
    """K6 over the whole run, one launch per chunk: (trained leaves,
    losses)."""
    from ..ops._build import library

    # K6's tile and its ELBO terms, checked before any step
    sfx, widths, idx = _kernel_args(xs.flatten(0, 1), leaves, run.sels,
                                    run.depth, backward=True,
                                    train_batch=xs.shape[1])
    xs = xs.contiguous()
    w = torch.cat([t.reshape(-1) for t in leaves])
    m, v, grad = torch.zeros_like(w), torch.zeros_like(w), torch.empty_like(w)
    losses = xs.new_empty(xs.shape[0])
    hyper = (ctypes.c_double * 7)(run.lr, run.b1, run.b2, run.eps, run.bb,
                                  run.var, run.log_z)
    args = (widths, idx, leaves[0].shape[0], hyper)
    with torch.cuda.device(xs.device):
        fn = getattr(library(), f"realnvp_train_{sfx}")
        for step0, steps in _chunks(xs.shape[0], chunk):
            _launch_chunk(fn, xs, w, m, v, grad, losses, run, step0, steps,
                          args)
    return _split(w, leaves), losses


def adam_train_realnvp_fused(xs, groups, idx_even, idx_odd, target,
                             base_loc, base_scale, lr, b1=0.9, b2=0.999,
                             eps=1e-8, chunk=512, backend="auto"):
    """Run a whole Adam/ELBO training run of a fused RealNVP stack.

    ``xs``: (n_steps, batch, d) presampled base draws, one batch a step.
    ``groups``: the stacked weights {'even'|'odd': {'s'|'t': [(W, b),
    ...]}}, as `FusedRealNVP.groups` holds them; not modified.
    ``target``: an `nft.Banana` of dimension d, or its ``log_prob``.
    ``base_loc``/``base_scale``: the diagonal-Gaussian base's (d,)
    parameters. K6 runs ``chunk`` steps a launch.

    Returns ``(groups_trained, losses)``: the trained weights as a groups
    dict of (W, b) tensors and the per-step losses (negative ELBO), shaped
    (n_steps,)."""
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    if not _use_kernel(backend, xs):
        return adam_train_plain(xs, groups, idx_even, idx_odd, target,
                                base_loc, base_scale, lr, b1, b2, eps)
    run, leaves = _prepare(xs, groups, idx_even, idx_odd, target, base_loc,
                           base_scale, lr, b1, b2, eps)
    with torch.no_grad():
        w, losses = _launch(xs, leaves, run, chunk)
    return _unflatten(w, run.depth), losses
