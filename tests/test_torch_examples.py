"""The port's demos and parity harness (`normalizingflows_torch/examples/`)
against the JAX package's (`examples/demo_*.py`, `benchmarks/parity.py`).

(a) Each demo's `main()` runs on the CPU for a few steps, and its flow,
batch and learning rate are the JAX demo's: the flow's `tree_size` (its
state_dict's size where it holds MADE's masks) equals the JAX flow's leaf
count, and the batch and rate (for the NSF envelope,
the schedule at the last step's count) are what the JAX demo passes to its
trainer and to `optax.adam`. The JAX demo runs up to its trainer call only
(its ELBO estimates and training are stubbed), so no JAX step compiles.
(b) The parity harness's rows carry exactly the JAX harness's keys, for an
ELBO row and the MLE row at 5 steps. (c) The pass band on made-up rows.
(d) The RealNVP and Hamiltonian rows' recipes, 200 steps on shared draws
against JAX.
"""

import copy
import importlib.util
import math
import pathlib
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.examples import parity  # noqa: E402
from normalizingflows_torch.utils.pytree import tree_size  # noqa: E402

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 4


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def _jax_demo(monkeypatch, name, **kw):
    """(flow leaf count, batch, learning rate or schedule) of a JAX demo,
    read at its trainer call."""
    mod = _load(ROOT / "examples" / f"{name}.py", f"jax_{name}")
    seen, real_adam = {}, optax.adam

    def adam(lr, *a, **k):
        seen["lr"] = lr
        return real_adam(lr, *a, **k)

    def train_flow(key, objective, flow, logp, n, **k):
        seen.update(flow=flow, batch=n)
        raise _Stop

    def train_flow_mle(flow, loader, **k):
        seen.update(flow=flow, batch=loader.batch)
        loader.close()
        raise _Stop

    monkeypatch.setattr(optax, "adam", adam)
    monkeypatch.setattr(nf, "train_flow", train_flow)
    monkeypatch.setattr(nf, "train_flow_mle", train_flow_mle)
    monkeypatch.setattr(nf, "elbo_batch", lambda *a, **k: 0.0)
    with pytest.raises(_Stop):
        mod.main(STEPS, **kw)
    monkeypatch.undo()
    size = sum(int(np.size(x)) for x in jax.tree_util.tree_leaves(
        seen["flow"]))
    return size, seen["batch"], seen["lr"]


def _port_demo(monkeypatch, name, tmp_path, **kw):
    """(result, flow, batch) of the port's demo run for STEPS steps on the
    CPU, its trainer's arguments seen on the way."""
    mod = _load(ROOT / "normalizingflows_torch" / "examples" / f"{name}.py",
                f"port_{name}")
    seen = {}
    train_flow, train_flow_mle = nft.train_flow, nft.train_flow_mle

    def spy(gen, objective, flow, logp, n, **k):
        seen.update(flow=flow, batch=n)
        return train_flow(gen, objective, flow, logp, n, **k)

    def spy_mle(flow, loader, **k):
        seen.update(flow=flow, batch=loader.batch)
        return train_flow_mle(flow, loader, **k)

    monkeypatch.setattr(nft, "train_flow", spy)
    monkeypatch.setattr(nft, "train_flow_mle", spy_mle)
    if name == "demo_maf_mle":
        kw["data_path"] = tmp_path / "maf.raw"
    res = mod.main(STEPS, device="cpu", show_progress=False, **kw)
    monkeypatch.undo()
    return res, seen["flow"], seen["batch"]


DEMOS = [("demo_realnvp", {}), ("demo_realnvp", {"use_stl": True}),
         ("demo_neural_spline_flow", {}),
         ("demo_neural_spline_flow", {"affine_wrap": True}),
         ("demo_planar_flow", {}), ("demo_radial_flow", {}),
         ("demo_hamiltonian_flow", {}), ("demo_glow", {}),
         ("demo_maf_mle", {})]


@pytest.mark.parametrize("name,kw", DEMOS,
                         ids=[n + ("_" + "_".join(k) if k else "")
                              for n, k in DEMOS])
def test_demo_matches_the_jax_demo(monkeypatch, tmp_path, capsys, name, kw):
    size, batch, lr = _jax_demo(monkeypatch, name, **kw)
    res, flow, port_batch = _port_demo(monkeypatch, name, tmp_path, **kw)
    assert res.flow is flow
    # the state_dict's elements are the JAX leaves; tree_size also counts
    # non-persistent buffers, MADE's masks and Permute's indices (static
    # fields in JAX), so it agrees where a flow has none
    assert sum(t.numel() for t in flow.state_dict().values()) == size
    if name != "demo_maf_mle":
        assert tree_size(flow) == size
    assert port_batch == batch
    losses = res.stats["loss"]
    assert len(losses) == STEPS and all(math.isfinite(v) for v in losses)
    port_lr = res.state.opt_state.param_groups[0]["lr"]
    if callable(lr):  # the envelope's schedule, at the last step's count
        want = float(lr(jnp.int32(STEPS - 1)))
        assert torch.is_tensor(port_lr)
        assert float(port_lr) == pytest.approx(want, rel=0, abs=4 * 2**-23
                                               * 5e-4)
    else:
        assert port_lr == lr
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "before:" in line and "after" in line


# (b) the parity harness's rows
@pytest.fixture()
def jax_parity(tmp_path, monkeypatch):
    mod = _load(ROOT / "benchmarks" / "parity.py", "jax_parity")
    monkeypatch.setattr(mod, "JSON_PATH", tmp_path / "PARITY.json")
    monkeypatch.setattr(mod, "MD_PATH", tmp_path / "PARITY.md")
    monkeypatch.setattr(mod, "FIG_DIR", tmp_path / "figures")
    monkeypatch.setattr(mod, "N_MOMENT", 2048)
    return mod


@pytest.mark.parametrize("workload", ["planar", "maf"])
def test_parity_rows_have_the_jax_keys(jax_parity, monkeypatch, tmp_path,
                                       workload):
    monkeypatch.setattr(parity, "N_MOMENT", 2048)
    want = jax_parity.WORKLOADS[workload][0](5)
    got = parity.WORKLOADS[workload][0](5, torch.device("cpu"),
                                        tmp_path / "figures")
    assert list(got) == list(want)
    assert got["iters"] == 5 and got["device"] == "cpu"
    assert pathlib.Path(got["figure"]).exists()
    for k, v in got.items():
        if isinstance(v, float):
            assert math.isfinite(v), k


def test_parity_workloads_are_the_jax_harness_s():
    mod = _load(ROOT / "benchmarks" / "parity.py", "jax_parity_counts")
    for name, (_, full, quick) in mod.WORKLOADS.items():
        assert parity.WORKLOADS[name][1:] == (full, quick)
    assert parity.WORKLOADS["realnvp_fused"][1:] == \
        parity.WORKLOADS["realnvp_k6"][1:] == mod.WORKLOADS["realnvp"][1:]
    assert set(parity.WORKLOADS) == set(mod.WORKLOADS) | {
        "realnvp_fused", "realnvp_k6"}


# (c) the band
@pytest.mark.parametrize("port,port_sem,jax_,jax_sem,passes,width", [
    (-0.30, 0.0, -0.3164, 0.0, True, 0.05),      # above the JAX row
    (-0.36, 0.0, -0.3164, 0.0, True, 0.05),      # within 0.05 nat
    (-0.37, 0.0, -0.3164, 0.0, False, 0.05),     # past it
    (-2.50, 0.01, -2.4701, 0.0028, True, 0.05),  # 3 × sems < 0.05
    (-2.55, 0.03, -2.4701, 0.0028, True, 0.0984),  # 3 × sems wider
    (-2.60, 0.03, -2.4701, 0.0028, False, 0.0984),
])
def test_band(port, port_sem, jax_, jax_sem, passes, width):
    row = {"elbo_after": port, "elbo_after_sem": port_sem, "iters": 10}
    ref = {"elbo_after": jax_, "elbo_after_sem": jax_sem, "iters": 10}
    b = parity.band(row, ref)
    assert b["pass"] is passes
    assert b["band"] == pytest.approx(width)
    # the MLE rows carry no SEM
    mle = parity.band({"elbo_after": port, "iters": 3},
                      {"elbo_after": jax_, "iters": 3})
    assert mle["band"] == parity.BAND_NATS


# (d) two rows' recipes step for step against JAX: 200 steps on shared draws


@pytest.mark.parametrize("name", ["realnvp", "hamiltonian"])
def test_parity_row_steps_match_jax(name):
    """The RealNVP row (float32) and the Hamiltonian row (float64) from
    their init, 200 Adam steps on the same numpy draws in both packages:
    the per-step losses agree (float32 rtol 1e-4, float64 rtol 1e-8), so
    the two packages take the same steps and a difference in a full
    row's final ELBO comes from the draws and the rounding of a long
    run."""
    from _parity_shared_draws import jax_arrays, train_both
    from normalizingflows_torch.utils.bridge import load_jax_params

    jres, res, _ = train_both(name, 200, 5)
    if name == "hamiltonian":  # a deterministic init: the port's own
        fresh = nft.hamiltonian_flow(2, nft.Funnel(2, -8.0, 5.0).score,
                                     n_blocks=15, L=3, eps0=0.05,
                                     dtype=torch.float64, device="cpu")
        ref = dict(load_jax_params(copy.deepcopy(fresh), jax_arrays(
            nf.hamiltonian_flow(2, nf.Funnel(2, -8.0, 5.0).score,
                                n_blocks=15, L=3, eps0=0.05,
                                dtype=jnp.float64))).named_parameters())
        for n, p in fresh.named_parameters():
            assert torch.equal(p, ref[n]), n
    tol = (1e-8, 1e-12) if name == "hamiltonian" else (1e-4, 1e-5)
    np.testing.assert_allclose(res.stats["loss"], jres.stats["loss"],
                               rtol=tol[0], atol=tol[1])
