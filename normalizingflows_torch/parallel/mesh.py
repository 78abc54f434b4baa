"""Device mesh construction for data-parallel ELBO training.

Counterpart of `normalizingflows/jl_tpu/parallel/mesh.py`. The ELBO is a
mean of i.i.d. per-sample terms and the flow's parameters are small, so
the parameters are replicated and only the Monte-Carlo batch is sharded,
over a 1-D mesh named ``"batch"``: one rank a device (a card for NCCL; with
gloo several ranks may share one). The mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the default
process group that `parallel.initialize` started.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard

from ..utils.device import resolve_device

__all__ = ["batch_mesh", "batch_sharding", "replicated_sharding", "BATCH_AXIS"]

BATCH_AXIS = "batch"


class Sharding(NamedTuple):
    """A mesh and its placements: ``distribute_tensor(t, *sharding)`` and
    ``DTensor.from_local(t, *sharding)`` take it as it is (JAX's
    ``NamedSharding``)."""

    device_mesh: DeviceMesh
    placements: tuple[Placement, ...]


def batch_mesh(n_devices: int | None = None, device=None) -> DeviceMesh:
    """1-D mesh with axis name ``"batch"`` over the group's ranks, or the
    first ``n_devices`` of them, on ``device``'s type (None: the card).

    A mesh over every rank reuses the default process group, so it opens
    no communicator of its own (two gloo ranks on one card never open an
    NCCL one). A mesh over fewer ranks makes a subgroup of the default
    group's backend; like every group, it is made by every rank."""
    if not dist.is_initialized():
        raise RuntimeError("batch_mesh needs a process group: call "
                           "parallel.initialize() first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices}: the group has {world} "
                         "ranks")
    return DeviceMesh(resolve_device(device).type, torch.arange(n),
                      mesh_dim_names=(BATCH_AXIS,))


def batch_sharding(mesh: DeviceMesh) -> Sharding:
    """Sharding for a (batch, dim) sample block: rows over the batch axis."""
    return Sharding(mesh, (Shard(0),))


def replicated_sharding(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, (Replicate(),))
