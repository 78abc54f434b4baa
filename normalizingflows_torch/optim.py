"""Adam with a learning-rate schedule that runs inside the train step.

Counterpart of the two pieces of optax the JAX package's demos and parity
rows use: `optax.warmup_cosine_decay_schedule` and `optax.adam(float |
schedule)` (`examples/demo_neural_spline_flow.py`, `benchmarks/parity.py`'s
``nsf`` row). The JAX package takes its schedules from optax; the port
provides this one schedule and nothing beyond it.

On the card the trainers replay their step from a CUDA graph, which bakes in
every Python float the step reads: a host-side `torch.optim.lr_scheduler`
writing a float into ``param_groups`` changes nothing under the graph. So
the schedule is torch ops on a count tensor, and `adam` keeps the group's
``lr`` as a 0-d tensor that a step pre-hook refills from the schedule inside
``opt.step()``; a capture records the hook's kernels, and every replay
recomputes the rate from the count that Adam keeps on the device.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch

__all__ = ["warmup_cosine_decay_schedule", "adam"]

Schedule = Callable[[torch.Tensor], torch.Tensor]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine decay to ``end_value`` over
    ``decay_steps - warmup_steps`` (optax's semantics and expressions:
    `optax.linear_schedule` and `optax.cosine_decay_schedule` joined at
    ``warmup_steps``, alpha = end_value / peak_value or 0 where the peak is
    0, the count clipped as they clip it).

    The schedule maps a count tensor to a rate tensor on the count's device
    by torch ops only (no host sync, no branch on the count), so a CUDA
    graph can capture it. It computes in float64 and returns the count's
    floating dtype (an integer count's: torch's default float dtype), so
    the card and the CPU give the same float32 rate: a float32 chain
    differs between them in its last bits (CUDA divides by a host scalar
    through its reciprocal, and the cosines round otherwise), which the
    warmup's and the decay's cancellations magnify to several ulps. Against
    optax, whose schedule computes in float32 from its int32 count (float64
    from a float64 count, with x64), the float32 rate agrees within a few
    ulps of the peak."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(
            "the cosine decay needs decay_steps > warmup_steps, got "
            f"decay_steps={decay_steps}, warmup_steps={warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = torch.as_tensor(count)
        dtype = (count.dtype if count.is_floating_point()
                 else torch.get_default_dtype())
        count = count.to(torch.float64)
        if warmup_steps > 0:
            # polynomial_schedule with power 1: (I − E)·(1 − c/T) + E
            frac = 1 - count.clamp(0, warmup_steps) / warmup_steps
            warm = (init_value - peak_value) * frac + peak_value
        else:  # optax: a constant init_value
            warm = torch.full_like(count, init_value)
        c = torch.clamp_max(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / cos_steps))
        decayed = (1 - alpha) * cosine ** exponent + alpha
        return torch.where(count < warmup_steps, warm,
                           peak_value * decayed).to(dtype)

    return schedule


def _fill_lr(schedule: Schedule):
    """A step pre-hook writing ``schedule(count)`` into each group's lr
    tensor, the count being Adam's step count before this update (0 before
    the first), as optax's `scale_by_learning_rate` reads its count before
    it increments. The rate comes in the lr tensor's dtype (the
    parameters')."""

    def hook(opt, args, kwargs):
        for group in opt.param_groups:
            # read from the group at every step: load_state_dict puts
            # another tensor there
            lr = group["lr"]
            state = opt.state.get(group["params"][0])
            if state and "step" in state:
                count = state["step"].to(device=lr.device, dtype=lr.dtype)
            else:
                count = torch.zeros((), dtype=lr.dtype, device=lr.device)
            lr.copy_(schedule(count))

    return hook


def adam(learning_rate: Union[float, Schedule], b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8
         ) -> Callable[[list], torch.optim.Optimizer]:
    """An optimizer factory ``params -> torch.optim.Adam``, the counterpart
    of ``optax.adam(learning_rate, b1, b2, eps)``, for the trainers'
    ``optimizer=``.

    A float rate gives ``Adam(lr=learning_rate)`` (which the trainers make
    capturable under their graph, as any caller's Adam). A schedule
    (`warmup_cosine_decay_schedule`) gives an Adam whose group ``lr`` is a
    0-d tensor in the parameters' dtype on their device, refilled before
    every update by a step pre-hook: step i (from 0) uses ``schedule(i)``,
    as in optax, so the parity schedule's first step (rate 0) leaves the
    parameters unchanged; bias correction uses i + 1 in both libraries.
    The count is the first parameter's Adam ``step``, so a run resumed from
    `utils.checkpoint.save_train_state` continues the schedule exactly.
    On the card the Adam is capturable (its step counts on the device,
    which the trainers' graph needs and the eager loop shares); on the CPU
    it takes the single-tensor update (``foreach=False``), the one torch
    allows with a tensor rate there."""

    def make(params) -> torch.optim.Optimizer:
        if not callable(learning_rate):
            return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2),
                                    eps=eps)
        params = list(params)
        like = params[0]
        on_cuda = like.is_cuda
        lr = torch.zeros((), dtype=like.dtype, device=like.device)
        opt = torch.optim.Adam(
            params, lr=lr, betas=(b1, b2), eps=eps, capturable=on_cuda,
            foreach=None if on_cuda else False)
        opt.register_step_pre_hook(_fill_lr(learning_rate))
        return opt

    return make
