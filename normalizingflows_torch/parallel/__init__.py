"""Multi-rank execution on `torch.distributed`: the launcher, the 1-D batch
mesh, batch-sharded objectives and sampling with per-rank generators.

Counterpart of `normalizingflows/jl_tpu/parallel/`, with its 13 names.
"""

from .distributed import (
    barrier,
    detect_cluster_env,
    host_count,
    host_index,
    initialize,
    is_multi_host,
)
from .mesh import (
    BATCH_AXIS,
    batch_mesh,
    batch_sharding,
    replicated_sharding,
)
from .sharded import per_shard_key, sample_sharded, shard_objective

__all__ = [
    "BATCH_AXIS",
    "batch_mesh",
    "batch_sharding",
    "replicated_sharding",
    "per_shard_key",
    "sample_sharded",
    "shard_objective",
    "initialize",
    "is_multi_host",
    "barrier",
    "detect_cluster_env",
    "host_count",
    "host_index",
]
