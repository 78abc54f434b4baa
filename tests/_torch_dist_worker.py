"""One rank of a gloo group for tests/test_torch_sharding.py.

    python tests/_torch_dist_worker.py INIT_URL WORLD RANK DIR CASE[,CASE...]

Imports torch and the port only. The rank joins the group through the
port's launcher (`parallel.initialize` with a ``file://`` rendezvous),
builds the batch mesh, runs each case and writes what it found to
``DIR/{case}_w{WORLD}_r{RANK}.npz`` for the test to compare:

  parity  the sharded ELBO's value and every parameter's gradient, on
          RealNVP and NSF in float32 and float64, with an objective that
          takes this rank's rows of the shared draws in ``DIR/inputs.npz``
          (the flows' weights come from there too, as JAX paths);
  stats   the sharded ELBO and gradient norm at 4,096 draws from
          per-rank generators, a sharded sample, and mean-field VI through
          `train_flow` with the sharded objective;
  bits    (one rank) `train_flow` with the wrapped objective and unwrapped,
          from generators in the same state: losses, gradient norms and
          final parameters, for `elbo_batch` and `elbo_stl`;
  dcp     a flow and a ``[Shard(0)]`` DTensor saved with
          ``save_pytree(backend="dcp")``, a barrier, and both loaded into
          a template of another seed.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch import parallel  # noqa: E402
from normalizingflows_torch.utils import checkpoint as ckpt  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402
from normalizingflows_torch.utils.pytree import global_norm  # noqa: E402

torch.set_num_threads(1)
DT = {"f32": torch.float32, "f64": torch.float64}


def parity_flow(kind, dt):
    """The test's RealNVP or NSF shape, on the CPU."""
    g = torch.Generator().manual_seed(0)
    if kind == "realnvp":
        return nft.realnvp(g, 2, (16, 16), nlayers=2, dtype=DT[dt],
                           device="cpu")
    return nft.nsf(g, 2, (8, 8), K=8, B=4.0, nlayers=2, dtype=DT[dt],
                   device="cpu")


def rank_rows(draws):
    """An objective on this rank's rows of ``draws``: rows r·n onward."""

    def objective(generator, flow, logp, n):
        r = dist.get_rank()
        return nft.elbo_from_samples(draws[r * n:(r + 1) * n], flow, logp)

    return objective


def case_parity(mesh, inputs):
    out = {}
    target = nft.Banana(2, 1.0, 10.0)
    for kind in ("realnvp", "nsf"):
        for dt in DT:
            tag = f"{kind}_{dt}"
            prefix = f"{tag}/"
            flow = load_jax_params(parity_flow(kind, dt), {
                k[len(prefix):]: v for k, v in inputs.items()
                if k.startswith(prefix)})
            draws = torch.from_numpy(inputs[f"draws_{dt}"])
            value = parallel.shard_objective(rank_rows(draws), mesh)(
                None, flow, target.log_prob, draws.shape[0])
            value.backward()
            out[f"{tag}:value"] = value.detach().numpy()
            for name, p in flow.named_parameters():
                out[f"{tag}:grad:{name}"] = p.grad.numpy()
    return out


def case_stats(mesh, inputs):
    out = {}
    target = nft.Banana(2, 1.0, 100.0)
    flow = nft.realnvp(torch.Generator().manual_seed(0), 2, (16, 16),
                       nlayers=2, device="cpu")
    sharded = parallel.shard_objective(nft.elbo_batch, mesh)
    value = sharded(parallel.per_shard_key(3, mesh, device="cpu"), flow,
                    target.log_prob, 4096)
    value.backward()
    out["value"] = value.detach().numpy()
    out["gnorm"] = global_norm([p.grad for p in flow.parameters()]).numpy()
    ys = parallel.sample_sharded(
        flow, parallel.per_shard_key(5, mesh, device="cpu"), 1024, mesh)
    out["sample_shape"] = np.asarray(ys.shape)
    out["sample_local"] = ys.to_local().detach().numpy()
    out["sample_placements"] = np.asarray([str(p) for p in ys.placements])
    out["sample_full"] = ys.full_tensor().detach().numpy()

    # mean-field VI through train_flow recovers DiagNormal(3, 0.5)
    target = nft.DiagNormal(torch.full((2,), 3.0), torch.full((2,), 0.5))
    flow = nft.create_flow(
        [nft.Scale(torch.ones(2)), nft.Shift(torch.zeros(2))],
        nft.DiagNormal(torch.zeros(2), torch.ones(2)))
    res = nft.train_flow(
        parallel.per_shard_key(7, mesh, device="cpu"),
        parallel.shard_objective(nft.elbo_batch, mesh), flow,
        target.log_prob, 64, max_iters=2000,
        optimizer=lambda p: torch.optim.Adam(p, lr=1e-2), check_every=500)
    out["vi_shift"] = res.flow.bijector.bijectors[1].b.detach().numpy()
    out["vi_scale"] = res.flow.bijector.bijectors[0].a.detach().numpy()
    out["vi_losses"] = res.stats["loss"]
    return out


def case_bits(mesh, inputs):
    out = {}
    target = nft.Banana(2, 1.0, 100.0)
    for objective in (nft.elbo_batch, nft.elbo_stl):
        for wrapped in (True, False):
            flow = nft.nsf(torch.Generator().manual_seed(1), 2, (8, 8), K=8,
                           B=4.0, nlayers=2, device="cpu")
            vo = (parallel.shard_objective(objective, mesh) if wrapped
                  else objective)
            res = nft.train_flow(
                parallel.per_shard_key(11, mesh, device="cpu"), vo, flow,
                target.log_prob, 32, max_iters=20, check_every=10,
                optimizer=lambda p: torch.optim.Adam(p, lr=5e-4))
            tag = f"{objective.__name__}:{'wrapped' if wrapped else 'plain'}"
            out[f"{tag}:loss"] = res.stats["loss"]
            out[f"{tag}:gnorm"] = res.stats["gradient_norm"]
            for name, p in flow.named_parameters():
                out[f"{tag}:param:{name}"] = p.detach().numpy()
    return out


def case_dcp(mesh, inputs):
    directory = str(Path(sys.argv[4]) / "dcp_ckpt")
    rows = 8 * mesh.size()
    full = torch.arange(rows * 4, dtype=torch.float32).reshape(rows, 4)
    sharding = parallel.batch_sharding(mesh)
    data = torch.distributed.tensor.distribute_tensor(full, *sharding)
    flow = nft.realnvp(torch.Generator().manual_seed(0), 2, (8, 8),
                       nlayers=2, device="cpu")
    ckpt.save_pytree(directory, {"flow": flow, "data": data}, backend="dcp")
    parallel.barrier()
    template = {
        "flow": nft.realnvp(torch.Generator().manual_seed(42), 2, (8, 8),
                            nlayers=2, device="cpu"),
        "data": torch.distributed.tensor.distribute_tensor(
            torch.zeros_like(full), *sharding)}
    restored = ckpt.load_pytree(directory, template, backend="dcp")
    local = restored["data"].to_local()
    r = mesh.get_local_rank()
    n = rows // mesh.size()
    return {"local": local.numpy(), "want_local": full[r * n:(r + 1) * n]
            .numpy(), "same_placements": np.asarray(
                restored["data"].placements == sharding.placements),
            "same_object": np.asarray(restored["data"] is template["data"]),
            **{f"param:{k}": v.detach().numpy() for k, v in
               restored["flow"].state_dict().items()},
            **{f"saved:{k}": v.detach().numpy() for k, v in
               flow.state_dict().items()}}


CASES = {"parity": case_parity, "stats": case_stats, "bits": case_bits,
         "dcp": case_dcp}


def main():
    init, world, rank, directory, cases = sys.argv[1:6]
    parallel.initialize(init, int(world), int(rank), device="cpu")
    mesh = parallel.batch_mesh(device="cpu")
    path = Path(directory) / "inputs.npz"
    inputs = dict(np.load(path)) if path.exists() else {}
    for case in cases.split(","):
        out = CASES[case](mesh, inputs)
        np.savez(Path(directory) / f"{case}_w{world}_r{rank}.npz", **out)
    parallel.barrier()
    dist.destroy_process_group()
    print("done", flush=True)


if __name__ == "__main__":
    main()
