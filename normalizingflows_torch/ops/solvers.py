"""Batched scalar root finding for bijector inverses without a closed form
(counterpart of `jl_tpu/ops/solvers.py`).

A fixed number of bisection halvings, then a few Newton steps, elementwise
over the batch: no data-dependent Python control flow and no host read, so
a CUDA graph captures it. The iterations run without a tape. The gradient
is the implicit-function one at the root, ∂x/∂θ = −(∂f/∂θ)/(∂f/∂x), as the
JAX package's `lax.custom_root` gives it: with x* the detached root,

    g = −f(x*) / f′(x*).detach(),    x = x* + (g − g.detach()),

whose value is x* exactly and whose gradient reaches every tensor ``f``
closes over (the layer's parameters and the data), though none of them is
an argument here.

`f` must be elementwise and increasing on the bracket [lo, hi], with
f(lo) <= 0 <= f(hi).
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["solve_monotone"]


def solve_monotone(
    f: Callable[[torch.Tensor], torch.Tensor],
    lo: torch.Tensor,
    hi: torch.Tensor,
    bisect_iters: int = 40,
    newton_iters: int = 3,
) -> torch.Tensor:
    """Root of the elementwise-increasing ``f`` on [lo, hi].

    40 halvings shrink the bracket by 2⁻⁴⁰ ≈ 1e-12 relative; Newton steps
    polish it to machine precision, clipped to the last bracket and kept
    only where finite. f′ is the gradient of Σf, which is JAX's `jax.jvp`
    with a tangent of ones because f is elementwise."""
    grad = torch.is_grad_enabled()
    with torch.no_grad():
        a, b = lo.detach(), hi.detach()
        for _ in range(bisect_iters):
            mid = 0.5 * (a + b)
            upper = f(mid) < 0
            a = torch.where(upper, mid, a)
            b = torch.where(upper, b, mid)
        x = 0.5 * (a + b)
        for _ in range(newton_iters):
            fx, dfx = _value_and_slope(f, x)
            step = fx / torch.where(dfx > 0, dfx, torch.ones_like(dfx))
            x_new = torch.clamp(x - step, a, b)
            x = torch.where(torch.isfinite(x_new), x_new, x)
    if not grad:
        return x
    fx = f(x)
    if not fx.requires_grad:
        return x
    g = -fx / _value_and_slope(f, x)[1]
    return x + (g - g.detach())


def _value_and_slope(f, x):
    """(f(x), f′(x)) for an elementwise ``f``, both detached."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        fx = f(xg)
        (dfx,) = torch.autograd.grad(fx.sum(), xg)
    return fx.detach(), dfx
