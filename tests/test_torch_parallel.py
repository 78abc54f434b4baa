"""The port's launcher and mesh helpers (`normalizingflows_torch.parallel`),
in-process, against the JAX package's `parallel.distributed`.

Cluster detection and the SLURM nodelist parser are pure Python in both
packages: every case of tests/test_distributed.py:26-74 goes through both
on the same dicts and strings. `initialize` runs with
`torch.distributed.init_process_group` replaced by a recorder, as the JAX
suite replaces `jax.distributed.initialize`. No process group is started
here; the groups of ranks are tests/test_torch_sharding.py's.
"""

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from normalizingflows.jl_tpu import parallel as jax_parallel  # noqa: E402
from normalizingflows.jl_tpu.parallel import (  # noqa: E402
    distributed as jax_dist,
)
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch import parallel  # noqa: E402
from normalizingflows_torch.parallel import distributed as pdist  # noqa

torch.set_num_threads(1)

ENVS = {
    "nf": {"NF_COORDINATOR": "10.0.0.1:9999", "NF_NUM_PROCESSES": "4",
           "NF_PROCESS_ID": "2"},
    "slurm_plain": {"SLURM_PROCID": "3", "SLURM_NTASKS": "8",
                    "SLURM_STEP_NODELIST": "hosta,hostb"},
    "slurm_ranged": {"SLURM_PROCID": "3", "SLURM_NTASKS": "8",
                     "SLURM_STEP_NODELIST": "tpu-node[017-020],tpu-node025"},
    "slurm_nodelist_var": {"SLURM_PROCID": "0", "SLURM_NTASKS": "2",
                           "SLURM_NODELIST": "n1,n2"},
    "slurm_no_nodelist": {"SLURM_PROCID": "0", "SLURM_NTASKS": "2"},
    "openmpi": {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "4",
                "NF_COORDINATOR_HOST": "head0"},
    "openmpi_default_host": {"OMPI_COMM_WORLD_RANK": "0",
                             "OMPI_COMM_WORLD_SIZE": "2"},
    "nf_over_slurm": {"NF_COORDINATOR": "a:1", "NF_NUM_PROCESSES": "2",
                      "NF_PROCESS_ID": "1", "SLURM_PROCID": "3",
                      "SLURM_NTASKS": "8", "SLURM_NODELIST": "n1"},
    "nothing": {},
}
NODELISTS = ("host[001-004,007]", "host[005,009-012]", "hosta,hostb",
             "host[001,003]", "tpu-[3-4]srv,other[1-2]", "single", "n[10]",
             "rack[1-2]node[01-08]", "a[1]b[2]c[3]")


@pytest.mark.parametrize(
    "case", [("env", k) for k in ENVS] + [("nodelist", s) for s in NODELISTS],
    ids=lambda c: f"{c[0]}-{c[1]}")
def test_cluster_detection_matches_jax(case):
    """`detect_cluster_env` and `_slurm_first_host` give JAX's answers on
    the JAX suite's dicts and nodelists, and its default port."""
    kind, arg = case
    assert pdist._DEFAULT_PORT == jax_dist._DEFAULT_PORT
    if kind == "env":
        got = pdist.detect_cluster_env(dict(ENVS[arg]))
        assert got == jax_dist.detect_cluster_env(dict(ENVS[arg]))
    else:
        got = pdist._slurm_first_host(arg)
        assert got == jax_dist._slurm_first_host(arg)
    assert got is not None


@pytest.fixture
def recorder(monkeypatch):
    """`init_process_group` replaced by a recorder of its arguments; no
    group is ever started."""
    calls = []

    def fake_init(**kw):
        calls.append(kw)

    for var in ("NF_COORDINATOR", "NF_NUM_PROCESSES", "NF_PROCESS_ID",
                "SLURM_PROCID", "SLURM_NTASKS", "OMPI_COMM_WORLD_RANK",
                "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(dist, "init_process_group", fake_init)
    return calls


def test_initialize_passthrough_and_env(recorder, monkeypatch):
    """Explicit arguments win; the NF_* variables fill missing ones;
    ``detect_env=False`` leaves the rendezvous to torchrun's variables;
    a URL is the rendezvous as given; the CPU means gloo."""
    parallel.initialize("1.2.3.4:1", 2, 1, device="cpu")
    assert recorder[-1] == dict(backend="gloo", init_method="tcp://1.2.3.4:1",
                                world_size=2, rank=1)

    monkeypatch.setenv("NF_COORDINATOR", "5.6.7.8:2")
    monkeypatch.setenv("NF_NUM_PROCESSES", "16")
    monkeypatch.setenv("NF_PROCESS_ID", "7")
    parallel.initialize(device="cpu")
    assert recorder[-1] == dict(backend="gloo", init_method="tcp://5.6.7.8:2",
                                world_size=16, rank=7)

    parallel.initialize(detect_env=False, device="cpu")
    assert recorder[-1] == dict(backend="gloo", init_method="env://",
                                world_size=-1, rank=-1)

    parallel.initialize("file:///tmp/rendezvous", 3, 0, device="cpu")
    assert recorder[-1]["init_method"] == "file:///tmp/rendezvous"


def test_initialize_idempotent_and_error_propagation(recorder, monkeypatch):
    """A second call, once a group runs, returns without a rendezvous (JAX
    swallows "already initialized"); a failing rendezvous raises; the
    card is the default and, without one, raises rather than fall back to
    gloo."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    parallel.initialize("x:1", 1, 0, device="cpu")
    assert recorder == []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)

    def refused(**kw):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(dist, "init_process_group", refused)
    with pytest.raises(RuntimeError, match="connection refused"):
        parallel.initialize("x:1", 1, 0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.initialize("x:1", 1, 0)


def test_single_host_helpers():
    """Without a group: one host, rank 0, and a barrier that touches no
    network; per-rank generators then use rank 0; a mesh needs a group."""
    assert not dist.is_initialized()
    assert parallel.host_count() == 1
    assert parallel.host_index() == 0
    assert not parallel.is_multi_host()
    parallel.barrier()
    a = parallel.per_shard_key(3, device="cpu")
    b = parallel.per_shard_key(3, device="cpu")
    assert torch.equal(torch.randn(8, generator=a),
                       torch.randn(8, generator=b))
    assert a.initial_seed() != parallel.per_shard_key(4, device="cpu") \
        .initial_seed()
    with pytest.raises(RuntimeError, match="initialize"):
        parallel.batch_mesh(device="cpu")


class _Mesh:
    """A 1-D mesh of ``n`` ranks, as far as the wrappers read one."""

    mesh_dim_names = ("batch",)

    def __init__(self, n):
        self.n = n

    def get_group(self, name):
        return None

    def size(self, dim=None):
        return self.n


@pytest.mark.parametrize("world", [2, 3])
def test_wrappers_refuse_a_batch_that_does_not_divide(world):
    """`shard_objective` and `sample_sharded` raise JAX's ValueError when n
    does not divide over the mesh, before any draw or collective."""
    flow = nft.realnvp(torch.Generator().manual_seed(0), 2, (8, 8),
                       nlayers=1, device="cpu")
    target = nft.Banana(2, 1.0, 10.0)
    sharded = parallel.shard_objective(nft.elbo_batch, _Mesh(world))
    with pytest.raises(ValueError, match="must divide evenly over "
                                         f"{world} devices"):
        sharded(torch.Generator(), flow, target.log_prob, 4 * world + 1)
    with pytest.raises(ValueError, match=f"over {world} devices"):
        parallel.sample_sharded(flow, torch.Generator(), 4 * world + 1,
                                _Mesh(world))


def test_names_are_the_jax_packages():
    """The 13 names of the JAX package's `parallel`, each callable but the
    axis name, which is the same string."""
    assert parallel.__all__ == jax_parallel.__all__
    assert len(parallel.__all__) == 13
    assert parallel.BATCH_AXIS == jax_parallel.BATCH_AXIS == "batch"
    assert all(callable(getattr(parallel, n)) for n in parallel.__all__
               if n != "BATCH_AXIS")
