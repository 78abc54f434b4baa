"""The port's sharded path (`normalizingflows_torch.parallel`) on gloo ranks,
against the JAX package's `shard_objective` on the conftest's 8 CPU devices.

Each group of ranks is a set of processes running
`tests/_torch_dist_worker.py` (torch only), which join through the port's
launcher with a ``file://`` rendezvous in a temporary directory; each
spawn has a timeout that kills every rank. Three groups: W = 2 (parity,
the statistical cases of tests/test_sharding.py, the DCP round trip),
W = 4 (parity) and W = 1 (the wrapped trainer's bits).

Parity goes through shared draws, since the packages' streams differ: JAX
slices the draws by ``axis_index`` inside ``shard_map``, the port's ranks
by rank, both sides the same 64 rows of numpy draws, and the unsharded
objective of each package runs on all of them. Every rank must end with
the mean of the ranks' gradients (1/W) Σ_r ∂l_r/∂θ, which is the
unsharded gradient: a backward that left each rank with its own shard's
gradient fails here. JAX runs its kernels as its own tests do
(``backend="pallas", interpret=True`` under `jax.jit`).

Tolerances: values and gradients between the packages and between
sharded and unsharded differ by summation order only: rtol 1e-5 in
float32 and 1e-9 in float64, with atol that rtol times the largest
element of the leaf (an element near 0 carries its leaf's roundoff).
"""

import copy
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.parallel import (  # noqa: E402
    batch_mesh as jax_batch_mesh,
    shard_objective as jax_shard_objective,
)
import normalizingflows_torch as nft  # noqa: E402
from _torch_dist_worker import parity_flow  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402
from normalizingflows_torch.utils.pytree import global_norm  # noqa: E402

torch.set_num_threads(1)

WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"
SPAWN_TIMEOUT = 120  # seconds for one group, every rank included
N = 64  # shared draws: 8 rows a JAX device, 32 / 16 a port rank
DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
RTOL = {"f32": 1e-5, "f64": 1e-9}
KINDS = ("realnvp", "nsf")


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _jax_flow(kind, dt):
    """The worker's shapes (`_torch_dist_worker.parity_flow`), moved off
    their init by noise of 0.1 on every parameter."""
    key = jax.random.key(0)
    jdt = DT[dt][0]
    if kind == "realnvp":
        flow = nf.realnvp(key, 2, (16, 16), nlayers=2, dtype=jdt)
    else:
        flow = nf.nsf(key, 2, (8, 8), K=8, B=4.0, nlayers=2, dtype=jdt,
                      backend="pallas", interpret=True)
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                        a.dtype), flow)


def _close(got, want, dt, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol = RTOL[dt]
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's 8-device sharded and unsharded value and gradients on the
    shared draws, for each flow and dtype; the weights and draws as the
    workers read them."""
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    mesh = jax_batch_mesh(8)
    target = nf.Banana(2, 1.0, 10.0)
    rng = np.random.default_rng(7)
    draws64 = rng.standard_normal((N, 2))
    inputs, results = {}, {}
    for dt in DT:
        draws = draws64.astype(DT[dt][2])
        inputs[f"draws_{dt}"] = draws
        jdraws = jnp.asarray(draws)

        def rows(key, flow, logp, n, jdraws=jdraws):
            i = jax.lax.axis_index("batch")
            xs = jax.lax.dynamic_slice_in_dim(jdraws, i * n, n)
            return nf.elbo_from_samples(xs, flow, logp)

        sharded = jax_shard_objective(rows, mesh)
        for kind in KINDS:
            flow = _jax_flow(kind, dt)
            arrays = jax_arrays(flow)
            inputs.update({f"{kind}_{dt}/{k}": v for k, v in arrays.items()})
            key = jax.random.key(0)
            out = {}
            for label, fn in (
                    ("sharded", lambda f: sharded(key, f, target.log_prob,
                                                  N)),
                    ("unsharded", lambda f: nf.elbo_from_samples(
                        jdraws, f, target.log_prob))):
                v, g = jax.jit(jax.value_and_grad(fn))(flow)
                out[label] = (float(v), jax_arrays(g))
            results[(kind, dt)] = (arrays, out)
    return inputs, results


def _spawn(directory: Path, world: int, cases: str) -> list:
    """``world`` ranks of the worker on ``cases``; each rank's results."""
    directory.mkdir(parents=True, exist_ok=True)
    init = f"file://{directory / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), init, str(world), str(r),
         str(directory), cases], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
    except subprocess.TimeoutExpired:
        pytest.fail(f"a group of {world} ranks ran past {SPAWN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [{case: dict(np.load(directory / f"{case}_w{world}_r{r}.npz"))
             for case in cases.split(",")} for r in range(world)]


@pytest.fixture(scope="module")
def groups(jax_side, tmp_path_factory):
    """World size → each rank's results: W = 2 and 4 on the JAX side's
    inputs, W = 1 for the trainer's bits."""
    inputs, _ = jax_side
    out = {}
    for world, cases in ((2, "parity,stats,dcp"), (4, "parity"),
                         (1, "bits")):
        directory = tmp_path_factory.mktemp(f"w{world}")
        if "parity" in cases:
            np.savez(directory / "inputs.npz", **inputs)
        out[world] = _spawn(directory, world, cases)
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dt", sorted(DT))
def test_sharded_value_and_gradients_match_jax(jax_side, groups, world,
                                                kind, dt):
    """Every rank's value and every leaf gradient equal JAX's 8-device
    `shard_objective`, JAX's unsharded objective and the port's unsharded
    one on the same 64 draws; the ranks agree bit for bit."""
    arrays, jax_out = jax_side[1][(kind, dt)]
    flow = load_jax_params(parity_flow(kind, dt), arrays)
    draws = torch.from_numpy(jax_side[0][f"draws_{dt}"])
    value = nft.elbo_from_samples(draws, flow, nft.Banana(2, 1.0, 10.0)
                                  .log_prob)
    value.backward()
    port_unsharded = (value.item(), {n: p.grad.numpy()
                                     for n, p in flow.named_parameters()})
    refs = {"jax sharded": jax_out["sharded"],
            "jax unsharded": jax_out["unsharded"]}
    for label, (v, g) in refs.items():
        grads = dict(load_jax_params(copy.deepcopy(flow), g)
                     .named_parameters())
        refs[label] = (v, {n: t.detach().numpy() for n, t in grads.items()})
    refs["port unsharded"] = port_unsharded
    tag = f"{kind}_{dt}"
    ranks = [r["parity"] for r in groups[world]]
    for rank, got in enumerate(ranks):
        for label, (v, g) in refs.items():
            _close(got[f"{tag}:value"], v, dt,
                   f"rank {rank} of {world}: value against {label}")
            assert set(g) == {k.split(":grad:")[1] for k in got
                              if k.startswith(f"{tag}:grad:")}
            for name, want in g.items():
                _close(got[f"{tag}:grad:{name}"], want, dt,
                       f"rank {rank} of {world}: {name} against {label}")
    for other in ranks[1:]:
        for k in ranks[0]:
            assert np.array_equal(ranks[0][k], other[k]), k


def test_sharded_elbo_and_gradient_close_to_unsharded(groups):
    """tests/test_sharding.py's statistics: the sharded ELBO at 4,096 draws
    from per-rank generators within 2 % of the unsharded one, and the
    gradient norms within 20 %."""
    target = nft.Banana(2, 1.0, 100.0)
    flow = nft.realnvp(torch.Generator().manual_seed(0), 2, (16, 16),
                       nlayers=2, device="cpu")
    value = nft.elbo_batch(torch.Generator().manual_seed(3), flow,
                           target.log_prob, 4096)
    value.backward()
    v_local = value.item()
    n_local = float(global_norm([p.grad for p in flow.parameters()]))
    for r in groups[2]:
        v_sharded, n_sharded = float(r["stats"]["value"]), float(
            r["stats"]["gnorm"])
        assert np.isfinite(v_sharded)
        assert abs(v_sharded - v_local) < 0.02 * abs(v_local)
        assert np.isfinite(n_sharded) and n_sharded > 0
        assert abs(n_sharded - n_local) / n_local < 0.2


def test_sharded_sampling(groups):
    """A (1024, 2) DTensor placed [Shard(0)], finite; rank r holds rows
    r·512 onward of the gathered whole, and the ranks' blocks differ (each
    rank its own stream)."""
    stats = [r["stats"] for r in groups[2]]
    for rank, s in enumerate(stats):
        assert tuple(s["sample_shape"]) == (1024, 2)
        assert list(s["sample_placements"]) == ["S(0)"]
        assert s["sample_local"].shape == (512, 2)
        assert np.isfinite(s["sample_full"]).all()
        np.testing.assert_array_equal(
            s["sample_full"][rank * 512:(rank + 1) * 512], s["sample_local"])
    assert not np.allclose(stats[0]["sample_local"], stats[1]["sample_local"])


def test_train_flow_with_sharded_objective(groups):
    """shard_objective drops into train_flow unchanged: mean-field VI on
    two ranks recovers DiagNormal(3, 0.5), and the ranks' runs agree bit
    for bit."""
    stats = [r["stats"] for r in groups[2]]
    for s in stats:
        assert np.all(np.abs(s["vi_shift"] - 3.0) < 0.2)
        assert np.all(np.abs(np.abs(s["vi_scale"]) - 0.5) < 0.2)
    for k in ("vi_shift", "vi_scale", "vi_losses"):
        assert np.array_equal(stats[0][k], stats[1][k]), k


@pytest.mark.parametrize("objective", ["elbo_batch", "elbo_stl"])
def test_one_rank_gives_the_unwrapped_bits(groups, objective):
    """At W = 1, `train_flow` with `shard_objective(objective, mesh)` gives
    the unwrapped run's losses, gradient norms and final parameters bit
    for bit, from generators in the same state (`elbo_stl` detaches the
    replicated parameters in its stopped copy)."""
    bits = groups[1][0]["bits"]
    keys = [k for k in bits if k.startswith(f"{objective}:wrapped:")]
    assert len(keys) > 2
    for k in keys:
        assert np.array_equal(bits[k], bits[k.replace(":wrapped:",
                                                      ":plain:")]), k
    assert np.isfinite(bits[f"{objective}:wrapped:loss"]).all()


def test_two_rank_dcp_round_trip(groups):
    """JAX's two-process orbax case (tests/test_distributed.py:173-210) on
    the port's `backend="dcp"`: a flow and a [Shard(0)] DTensor saved,
    a barrier, then loaded into a template of another seed: every local
    shard holds its saved rows, in the template's DTensor with its
    placements, and the flow's tensors are the saved ones bit for bit, on
    both ranks alike."""
    sums = []
    for r in groups[2]:
        d = r["dcp"]
        np.testing.assert_array_equal(d["local"], d["want_local"])
        assert bool(d["same_placements"]) and bool(d["same_object"])
        params = [k for k in d if k.startswith("param:")]
        assert params
        for k in params:
            np.testing.assert_array_equal(d[k], d["saved:" + k[6:]])
        sums.append(sum(float(d[k].sum()) for k in params))
    assert sums[0] == sums[1]
