"""Batch-sharded objectives and sampling over a 1-D batch mesh.

Counterpart of `normalizingflows/jl_tpu/parallel/sharded.py`. Parameters
are replicated, the Monte-Carlo sample batch is sharded: each rank
evaluates the objective on n / W samples drawn from its own generator
(`per_shard_key`), and the per-rank values are averaged.

The gradient is JAX's. In JAX the value is ``pmean`` of the per-shard
values inside ``shard_map``, and the flow enters replicated
(``in_specs=P()``). Reverse mode transposes each of the two:

  * the transpose of ``pmean`` takes the replicated cotangent g of the
    mean to g / W on every shard, with no collective;
  * the transpose of a replicated input is a ``psum``: the parameter
    cotangents of the shards are summed.

So every rank ends with (1/W) Σ_r ∂l_r/∂θ. Here the two transposes are
two `torch.autograd.Function`s: `_MeanAcross` (forward ``all_reduce(SUM) /
W``, backward g / W) around the value, and `_Replicated` (forward the
identity, backward one ``all_reduce(SUM)`` of all the parameter gradients
in one buffer) around the flow's trainable parameters, which
reach the objective through `torch.func.functional_call`. That is two
collectives a step. A differentiable all-reduce of the value alone
(``torch.distributed.nn.functional.all_reduce``) would be wrong: its
backward all-reduces the cotangent, which is already replicated, and
leaves each rank with the gradient of its own shard, so the replicas
would drift apart from the first step.

At W = 1 each collective is the identity and each division is by 1, so
the wrapped objective gives the unwrapped one's bits.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..models.distributions import TransformedDistribution
from ..utils.device import resolve_device
from .mesh import BATCH_AXIS, batch_sharding

__all__ = ["shard_objective", "sample_sharded", "per_shard_key"]


def _rank(mesh_or_group) -> int:
    if isinstance(mesh_or_group, DeviceMesh):
        return mesh_or_group.get_local_rank()
    if mesh_or_group is not None:
        return dist.get_rank(mesh_or_group)
    return dist.get_rank() if dist.is_initialized() else 0


def per_shard_key(seed: int, mesh_or_group=None,
                  device=None) -> torch.Generator:
    """This rank's generator on ``device`` (None: the card), seeded from
    (``seed``, rank) by `numpy.random.SeedSequence`: the ranks' streams
    differ, and a rank's stream is the same from run to run (JAX folds the
    shard index into the key, ``fold_in(key, axis_index)``). The rank is
    its coordinate on a `DeviceMesh`, in a process group, or in the
    default group (0 without one).

    Make it before the run and pass it to `train_flow`, with the sharded
    objective: the trainer registers its generator with the CUDA graph of
    the step, so each replay draws anew. A generator made inside the step
    would not be registered, and every replay would reuse the capture's
    draws."""
    rank = _rank(mesh_or_group)
    state = np.random.SeedSequence((seed, rank)).generate_state(1, np.uint64)
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(state[0]))


class _MeanAcross(torch.autograd.Function):
    """The transpose pair of ``pmean``: forward the mean over the group's
    ranks, backward g / W on each rank with no collective (the cotangent
    of the mean is replicated)."""

    @staticmethod
    def forward(ctx, value, group, world):
        ctx.world = world
        out = value.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / world

    @staticmethod
    def backward(ctx, g):
        return g / ctx.world, None, None


# Where each gradient starts in `_Replicated`'s buffer: a multiple of 64
# bytes, as a tensor of its own starts. The foreach kernels (the gradient
# norm's `_foreach_norm`) take a vectorized path, which sums in another
# order, only where a tensor is aligned, so an unaligned view would change
# the gradient norm's bits.
_ALIGN_BYTES = 64


class _Replicated(torch.autograd.Function):
    """The transpose pair of a replicated input: forward the parameters as
    they are (views), backward the sum of every rank's parameter gradients
    by one ``all_reduce(SUM)`` of one buffer that holds them all, each at
    an aligned offset; the gradients are views of it. A parameter the
    objective did not reach keeps no gradient, as unwrapped; every rank
    runs the same objective, so the ranks' buffers have one layout."""

    @staticmethod
    def forward(ctx, group, *params):
        ctx.group = group
        ctx.set_materialize_grads(False)
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        present = [g for g in grads if g is not None]
        if not present:
            return (None,) + grads
        if len({g.dtype for g in present}) > 1:
            raise TypeError("shard_objective needs the flow's trainable "
                            "parameters in one dtype, got "
                            f"{sorted({str(g.dtype) for g in present})}")
        step = max(1, _ALIGN_BYTES // present[0].element_size())
        starts, at = [], 0
        for g in present:
            starts.append(at)
            at += -(-g.numel() // step) * step
        flat = present[0].new_empty(at)
        views = [flat[a:a + g.numel()].view_as(g)
                 for a, g in zip(starts, present)]
        torch._foreach_copy_(views, present)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.group)
        views = iter(views)
        return (None, *(None if g is None else next(views) for g in grads))


class _Bound(nn.Module):
    """``objective(input, flow, *args)`` as a module's forward, for
    `functional_call`."""

    def __init__(self, objective, flow):
        super().__init__()
        self.objective, self.flow = objective, flow

    def forward(self, inp, *args):
        return self.objective(inp, self.flow, *args)


def _axis(mesh: DeviceMesh, axis_name: str):
    """(the axis's process group, its size)."""
    return mesh.get_group(axis_name), mesh.size(mesh.mesh_dim_names.index(
        axis_name))


def shard_objective(
    objective: Callable[..., torch.Tensor],
    mesh: DeviceMesh,
    axis_name: str = BATCH_AXIS,
) -> Callable[..., torch.Tensor]:
    """Lift ``vo(generator, flow, *args, n)`` into a batch-sharded estimator.

    The returned callable has the same signature; the trailing argument
    must be the Monte-Carlo sample count, which is split evenly across the
    mesh. Each rank evaluates the objective on its own generator (pass
    each rank's `per_shard_key`) and n / W samples; the value is the mean
    over the ranks, and the flow's trainable parameters get the mean of the
    ranks' gradients (the module docstring). It is a drop-in objective for
    `train_flow`, graphed or eager."""
    group, world = _axis(mesh, axis_name)

    def sharded(generator, flow, *args):
        *rest, n = args
        if n % world != 0:
            raise ValueError(
                f"n_samples={n} must divide evenly over {world} devices")
        named = [(k, p) for k, p in flow.named_parameters()
                 if p.requires_grad]
        replicated = _Replicated.apply(group, *(p for _, p in named))
        local = torch.func.functional_call(
            _Bound(objective, flow),
            {f"flow.{k}": r for (k, _), r in zip(named, replicated)},
            (generator, *rest, n // world))
        return _MeanAcross.apply(local, group, world)

    return sharded


def sample_sharded(
    flow: TransformedDistribution,
    generator: torch.Generator,
    n: int,
    mesh: DeviceMesh,
    axis_name: str = BATCH_AXIS,
) -> DTensor:
    """Draw n flow samples with the batch axis sharded over the mesh: each
    rank draws n / W rows with ``flow.sample`` from ``generator`` (pass
    each rank's `per_shard_key`), and the result is a `DTensor` of global
    shape (n, d) placed ``[Shard(0)]``, rank r holding rows r·n/W onward.
    One batched forward a rank, no collective."""
    _, world = _axis(mesh, axis_name)
    if n % world != 0:
        raise ValueError(f"n={n} must divide evenly over {world} devices")
    local = flow.sample(generator, (n // world,))
    shape = torch.Size((n,) + local.shape[1:])
    return DTensor.from_local(local, *batch_sharding(mesh), shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())
