"""Multi-process startup and cross-rank conventions.

Counterpart of `normalizingflows/jl_tpu/parallel/distributed.py`. Where the
JAX package wires up the JAX distributed runtime, `initialize()` starts a
`torch.distributed` process group: NCCL on the card, gloo on the CPU. Each
rank runs the same program on its own slice of the Monte-Carlo batch; the
1-D batch mesh of `parallel.mesh` spans the group, and the sharded
objective's two collectives (`parallel.sharded`) ride the group's backend.

Reproducibility contract: each rank draws from its own generator, seeded
from (seed, rank) by `per_shard_key`, so a W-rank run is statistically
equivalent to a one-rank run with W times the Monte-Carlo batch, not
bitwise: the draws are partitioned differently.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = [
    "initialize",
    "is_multi_host",
    "host_count",
    "host_index",
    "detect_cluster_env",
    "barrier",
]

_DEFAULT_PORT = 8476


def detect_cluster_env(
    environ=None,
) -> tuple[str | None, int | None, int | None]:
    """Detect (coordinator_address, num_processes, process_id) from launcher
    environment variables.

    Recognized, in priority order:

      * explicit `NF_COORDINATOR` / `NF_NUM_PROCESSES` / `NF_PROCESS_ID`
        (this framework's own launcher contract);
      * SLURM: `SLURM_STEP_NODELIST` (first host) + `SLURM_NTASKS` +
        `SLURM_PROCID`;
      * OpenMPI (mpirun): `NF_COORDINATOR_HOST` (default 127.0.0.1) +
        `OMPI_COMM_WORLD_SIZE` + `OMPI_COMM_WORLD_RANK`.

    Returns (None, None, None) when nothing is recognized: `initialize`
    then leaves the rendezvous to torchrun's variables (``env://``).
    """
    env = os.environ if environ is None else environ

    if "NF_COORDINATOR" in env:
        return (
            env["NF_COORDINATOR"],
            int(env["NF_NUM_PROCESSES"]),
            int(env["NF_PROCESS_ID"]),
        )

    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST"))
        if nodelist:
            return (
                f"{_slurm_first_host(nodelist)}:{_DEFAULT_PORT}",
                int(env["SLURM_NTASKS"]),
                int(env["SLURM_PROCID"]),
            )

    if "OMPI_COMM_WORLD_RANK" in env and "OMPI_COMM_WORLD_SIZE" in env:
        coord = env.get("NF_COORDINATOR_HOST", "127.0.0.1")
        return (
            f"{coord}:{_DEFAULT_PORT}",
            int(env["OMPI_COMM_WORLD_SIZE"]),
            int(env["OMPI_COMM_WORLD_RANK"]),
        )

    return None, None, None


def _slurm_first_host(nodelist: str) -> str:
    """First hostname of a SLURM compressed nodelist.

    Handles every `scontrol show hostnames`-style shape:
    ``host[001-004,007]`` → host001; ``host[005,009-012]`` → host005;
    ``hosta,hostb`` → hosta; ``tpu-[3-4]srv,x`` (suffix after brackets) →
    tpu-3srv. Only the first host is needed (it runs the coordinator).
    """
    # split on commas outside brackets to isolate the first element
    depth, first = 0, []
    for ch in nodelist:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            break
        first.append(ch)
    s = "".join(first)
    # expand every bracket group ("rack[1-2]node[01-08]" is a valid
    # scontrol shape): loop until no '[' remains
    while "[" in s:
        prefix, rest = s.split("[", 1)
        body, _, suffix = rest.partition("]")
        # first element of the range list: "001-004,007" → "001"
        first_item = body.split(",")[0].split("-")[0]
        s = prefix + first_item + suffix
    return s


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    detect_env: bool = True,
    device=None,
) -> None:
    """Start the default `torch.distributed` process group (idempotent: a
    second call returns).

    Explicit arguments override everything; otherwise ``detect_env=True``
    fills them from NF_* / SLURM / OpenMPI launcher variables
    (`detect_cluster_env`). A coordinator ``host:port`` becomes the
    ``tcp://`` rendezvous of ``num_processes`` ranks, and a URL (such as
    ``file:///shared/path``) is the rendezvous as given; without one the
    group reads torchrun's variables (``env://``: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK).

    ``device`` picks the backend: the card (None, the default, or a CUDA
    device) means NCCL, one card a rank, the rank's card chosen as
    ``LOCAL_RANK`` (else the rank) modulo the cards on the host;
    ``device="cpu"`` means gloo, which also carries CUDA tensors through
    the host, so two ranks can share one card. Errors of the rendezvous
    propagate.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None and detect_env:
        coordinator_address, det_n, det_i = detect_cluster_env()
        if num_processes is None:
            num_processes = det_n
        if process_id is None:
            process_id = det_i
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = (process_id if process_id is not None
                     else os.environ.get("RANK", 0))
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def is_multi_host() -> bool:
    return host_count() > 1


def host_count() -> int:
    """The group's ranks; 1 when no group was started."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_index() -> int:
    """This process's rank; 0 when no group was started."""
    return dist.get_rank() if dist.is_initialized() else 0


def barrier(name: str = "nf_barrier") -> None:
    """Block until every rank reaches this point (a no-op, touching no
    network, with one rank): fences host-side work such as checkpoint
    writes. ``name`` is kept for the JAX package's signature; the group's
    barrier needs none."""
    if host_count() <= 1:
        return
    dist.barrier()
