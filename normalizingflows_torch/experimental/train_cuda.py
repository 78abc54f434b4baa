"""Whole-run RealNVP ELBO training: the CUDA kernel K6 and its plain version.

Counterpart of `normalizingflows/jl_tpu/experimental/train_pallas.py`.
`adam_train_realnvp_fused` runs a whole reverse-KL training run of a fused
RealNVP stack with Adam in launches of ``chunk`` steps of K6
``realnvp_train`` (``csrc/train.cu``, ``csrc/train_bf16.cu``), the port of
the Pallas `_train_kernel`. Per step, on that step's presampled base
draws: the stack forward with its log-det, the target log-density, the
negative ELBO (stored to ``losses``), the hand-written reverse sweep of K5
and the Adam update, optax.adam's formula (bias-corrected moments, eps
outside the square root) at the global step. Between launches the flat
weights and Adam moments stay in device memory and the step index
advances, as the JAX wrapper threads them between its launches.

The target is a device function, not a callable: K6 evaluates the
log-density and its gradient itself, so ``target`` must be one of the
targets JAX's kernel takes as a built-in, an `nft.Banana`, `nft.Funnel`
(2 ≤ d ≤ 8) or `nft.WarpedGauss` (d = 2) of the flow's dimension, or its
bound ``log_prob``. Its id and scalars go into the launch (the JAX
kernel's "Python-scalar closure constants"). Any other target raises,
`GaussianMixture` and `Cross` too: JAX's kernel refuses them, since its
Pallas call cannot capture their component arrays.

bfloat16 parameters (x, the weights and the base in bfloat16) run
``realnvp_train_bf16``: it stores the weights, Adam's moments and the
losses in bfloat16 (the JAX kernel's dtypes), computes in float32 and
rounds each stored value once a step. Its bias corrections are float32,
optax.adam's: the Pallas kernel computes 1 − βᵗ in bfloat16, where
1 − 0.999 rounds to 0 at t = 1 and the run turns NaN.

Beside K6 is its plain version `adam_train_plain`, a transcription of
`_train_kernel` in torch: `tile_flow`, the target's log-density and its
written-out gradient, `tile_flow_bwd` under those cotangents over the whole
batch, and the same Adam formula, on bfloat16 storage widened to float32
and rounded once a step as K6 does. ``backend="auto"`` launches K6 for
CUDA tensors and runs the plain version for CPU tensors; ``"plain"``
always runs the plain version; ``"cuda"`` raises without CUDA tensors.
Nothing falls back. K6 runs K5's lane tile, its rows fitted to the batch,
plus a word a row for the ELBO terms, so it has a cap on blocks like K5's
and raises before any step runs (`coupling_cuda._kernel_args`). Each K6
launch is counted in `ops/launches.py`, the bfloat16 one apart.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..models.targets import Banana, Funnel, GaussianMixture, WarpedGauss
from ..ops import launches
from .coupling_cuda import (
    KERNEL_MAX_D,
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

__all__ = ["adam_train_realnvp_fused", "adam_train_plain"]

_LOG_2PI = 1.8378770664093453
# the targets K6 evaluates itself, and their ids in csrc/train_kernel.cuh
BANANA, FUNNEL, WARPED_GAUSS = 0, 1, 2
TARGETS = {Banana: BANANA, Funnel: FUNNEL, WarpedGauss: WARPED_GAUSS}


class _Run(NamedTuple):
    """What a run holds fixed: the stack's index sets and depth, the base,
    Adam's constants, and the target's id and its four scalars (K6's
    ``Train::c``)."""

    sels: tuple
    depth: int
    loc: torch.Tensor
    scale: torch.Tensor
    lr: float
    b1: float
    b2: float
    eps: float
    target: int
    consts: tuple


def _target(target, d: int):
    """(id, scalars) of ``target``, a Banana, Funnel or WarpedGauss of
    dimension d or its ``log_prob``. The scalars: Banana b, var, log Z;
    Funnel μ, σ, (d−1)/2, log Z = ½·d·log 2π + log σ; WarpedGauss σ₁, σ₂,
    log Z = log 2π + log σ₁ + log σ₂, ref_compat as 1.0 or 0.0."""
    obj = getattr(target, "__self__", target)
    if target is not obj and target != getattr(obj, "log_prob", None):
        obj = target  # a method other than log_prob
    if isinstance(obj, GaussianMixture):
        raise ValueError(
            "the whole-run training kernel takes nft.Banana, nft.Funnel or "
            "nft.WarpedGauss (or their log_prob) as target; a "
            "GaussianMixture (Cross is one) is refused, as JAX's kernel "
            "refuses it: its Pallas call cannot capture the component "
            "arrays")
    if type(obj) not in TARGETS:
        raise ValueError(
            "the whole-run training kernel evaluates the target's "
            "log-density and its gradient itself and takes nft.Banana, "
            "nft.Funnel or nft.WarpedGauss (or their log_prob) as target, "
            f"the targets JAX's kernel takes; got {target!r}")
    name = type(obj).__name__
    if obj.event_dim != d:
        raise ValueError(f"{name} of dimension {obj.event_dim} for a flow "
                         f"of dimension {d}")
    if isinstance(obj, Funnel):
        if d > KERNEL_MAX_D:
            raise ValueError(f"Funnel of dimension {d}: the kernel takes "
                             f"2 <= d <= {KERNEL_MAX_D}")
        return FUNNEL, (obj.mu, obj.sigma, 0.5 * (d - 1),
                        0.5 * d * _LOG_2PI + math.log(obj.sigma))
    if isinstance(obj, WarpedGauss):
        return WARPED_GAUSS, (obj.sigma1, obj.sigma2,
                              _LOG_2PI + math.log(obj.sigma1)
                              + math.log(obj.sigma2),
                              float(obj.ref_compat))
    return BANANA, (obj.b, obj.var,
                    0.5 * (d * _LOG_2PI + math.log(obj.var)), 0.0)


def _prepare(xs, groups, idx_even, idx_odd, target, base_loc, base_scale,
             lr, b1, b2, eps):
    if xs.dim() != 3:
        raise ValueError(f"xs must be (n_steps, batch, d), got "
                         f"{tuple(xs.shape)}")
    d = xs.shape[-1]
    kind, consts = _target(target, d)
    base = [torch.broadcast_to(torch.as_tensor(t).detach(), (d,)).to(
        device=xs.device, dtype=xs.dtype).contiguous()
        for t in (base_loc, base_scale)]
    run = _Run(_sels(idx_even, idx_odd, d), _depth(groups), base[0], base[1],
               float(lr), float(b1), float(b2), float(eps), kind, consts)
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

def _log_p_and_grad(y, run: _Run):
    """log p(y) (batch,) and ∂log p/∂y (batch, d) of the run's target,
    written out as K6 computes them (`target_logp`)."""
    c = run.consts
    y0, y1, rest = y[:, 0], y[:, 1], y[:, 1:]
    if run.target == FUNNEL:
        # e = e^{−y₀}, S = Σ_{j≥1} y_j², q = (y₀ − μ)/σ: log p = −q²/2 −
        # e·S/2 − (d−1)/2·y₀ − log Z; ∂₀ = −q/σ − (d−1)/2 + e·S/2 (JAX's
        # Funnel.score), ∂_j = −e·y_j
        e, s = torch.exp(-y0), (rest * rest).sum(dim=-1)
        q = (y0 - c[0]) / c[1]
        log_p = -0.5 * (q * q) - 0.5 * (e * s) - c[2] * y0 - c[3]
        g0 = -q / c[1] - c[2] + 0.5 * e * s
        return log_p, torch.cat([g0[:, None], -e[:, None] * rest], dim=1)
    if run.target == WARPED_GAUSS:
        # (zx, zy) = y rotated by r/2; p = zx/σ₁, q = zy/σ₂, u = p/σ₁,
        # v = q/σ₂, w = (v·zx − u·zy)/(2r): ∂₀ = −(u·c + v·s) − y₀·w,
        # ∂₁ = −(v·c − u·s) − y₁·w; ref_compat adds log r and y/r²
        r2 = y0 * y0 + y1 * y1
        r = torch.sqrt(r2)
        sn, cs = torch.sin(0.5 * r), torch.cos(0.5 * r)
        zx, zy = y0 * cs - y1 * sn, y0 * sn + y1 * cs
        p, q = zx / c[0], zy / c[1]
        pu, qv = p / c[0], q / c[1]
        w = (qv * zx - pu * zy) / (2.0 * r)
        g = torch.stack([-(pu * cs + qv * sn) - y0 * w,
                         -(qv * cs - pu * sn) - y1 * w], dim=1)
        log_p = -0.5 * (p * p + q * q) - c[2]
        if c[3]:
            return log_p + torch.log(r), g + y / r2[:, None]
        return log_p, g
    # Banana: z = y₁ + b·y₀² − var·b; ∂log p/∂y₀ = −(y₀/var + 2b·y₀·z),
    # ∂/∂y₁ = −z, ∂/∂y_j = −y_j
    more = y[:, 2:]
    z = y1 + c[0] * (y0 * y0) - c[1] * c[0]
    log_p = -c[2] - 0.5 * ((y0 * y0) / c[1] + z * z
                           + (more * more).sum(dim=-1))
    return log_p, torch.cat([(-(y0 / c[1] + 2.0 * c[0] * y0 * z))[:, None],
                             (-z)[:, None], -more], dim=1)


def _loss_and_grads(x, w, run: _Run):
    """The negative ELBO on x (batch, d) and its gradient with respect to
    the leaves w, by `tile_flow` and the manual sweep `tile_flow_bwd` under
    the cotangents of the loss, as `_train_kernel` takes them."""
    batch, d = x.shape
    groups = _unflatten(w, run.depth)
    y, ld = tile_flow(x, groups, run.sels)
    log_p, dlog_p = _log_p_and_grad(y, run)
    zq = (x - run.loc) / run.scale
    log_q0 = (-0.5 * (zq * zq).sum(dim=-1) - torch.log(run.scale).sum()
              - 0.5 * d * _LOG_2PI)
    loss = -(log_p - log_q0 + ld).sum() / batch
    neg_inv_b = -(1.0 / batch)
    _, tree = tile_flow_bwd(x, groups, neg_inv_b * dlog_p,
                            x.new_full((batch,), neg_inv_b), run.sels)
    return loss, _leaves(tree)


def _adam(w, m, v, grads, t: int, run: _Run):
    """optax.adam's update at global step t, in place; the bias
    corrections 1 − βᵗ as exp(t·log β), in the arithmetic's dtype (float32
    for bfloat16 storage)."""
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
    index. bfloat16 storage computes in float32 and rounds the weights,
    the moments and the loss once a step, as K6 on `Bf16Storage` does."""
    store = xs.dtype
    wide = torch.float32 if store == torch.bfloat16 else store
    run = run._replace(loc=run.loc.to(wide), scale=run.scale.to(wide))
    w = [t.to(wide, copy=True) for t in leaves]
    m = [torch.zeros_like(t) for t in w]
    v = [torch.zeros_like(t) for t in w]
    losses = xs.new_empty(xs.shape[0])
    for s in range(xs.shape[0]):
        losses[s], grads = _loss_and_grads(xs[s].to(wide), w, run)
        _adam(w, m, v, grads, s + 1, run)
        if wide != store:
            for t in (*w, *m, *v):
                t.copy_(t.to(store))
    return [t.to(store) for t in w], losses


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
    n_steps, batch, d = xs.shape
    widths, idx, n_blocks, hyper, name = args
    err = fn(xs[step0].data_ptr(), w.data_ptr(), m.data_ptr(), v.data_ptr(),
             grad.data_ptr(), losses[step0].data_ptr(), run.loc.data_ptr(),
             run.scale.data_ptr(), steps, step0, batch, d, n_blocks,
             run.depth, widths, idx, run.target, hyper,
             torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    launches.count(name)


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
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    # the gradient buffer is in the arithmetic's dtype
    grad = torch.empty_like(w, dtype=torch.float32 if w.dtype ==
                            torch.bfloat16 else w.dtype)
    losses = xs.new_empty(xs.shape[0])
    hyper = (ctypes.c_double * 8)(run.lr, run.b1, run.b2, run.eps,
                                  *run.consts)
    args = (widths, idx, leaves[0].shape[0], hyper,
            launches.name_of("realnvp_train", sfx))
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
    ...]}}, as `FusedRealNVP.groups` holds them; not modified. float32,
    float64, or bfloat16 (K6's bfloat16 entry), the dtype of ``xs``.
    ``target``: an `nft.Banana`, `nft.Funnel` (2 ≤ d ≤ 8) or
    `nft.WarpedGauss` (d = 2) of dimension d, or its ``log_prob``.
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
