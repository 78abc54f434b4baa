"""The port's experiment configs against the JAX package's.

A JSON written by the JAX package's `config_to_json` is the port's: it
rebuilds the same dataclasses, and for each of the eight families
`FlowConfig.build` makes the torch flow that `load_jax_params` fills from
the JAX package's `FlowConfig.build` flow, with equal `log_prob` (float64,
rtol 1e-9). `TrainConfig.run` trains: the ELBO improves; maximum likelihood
reads an array, a ``.npy`` file or a raw float32 file (through the native
loader, from the config's seed), and on the JAX package's batches follows
JAX's `TrainConfig.run` trajectory.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu import config as jcfg  # noqa: E402
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch import config as tcfg  # noqa: E402
from normalizingflows_torch.train import TrainState  # noqa: E402
from normalizingflows_torch.utils import data  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402
from normalizingflows_torch.utils.pytree import (  # noqa: E402
    trainable_parameters,
)

torch.set_num_threads(1)

FAMILIES = ("planar", "radial", "realnvp", "nsf", "maf", "iaf", "glow",
            "hamiltonian")


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _train_cfg(module, **flow):
    return module.TrainConfig(
        flow=module.FlowConfig(**flow),
        optimizer=module.OptimizerConfig(name="adamw", learning_rate=3e-4,
                                         b2=0.99),
        max_iters=50, n_samples=8, objective="elbo_stl", seed=7,
        data_path="x.f32", batch_size=64, unroll=4)


def test_json_round_trip_matches_the_jax_layout():
    """Either package's JSON is the other's, field for field; both
    rebuild equal dataclasses, defaults included."""
    flow = dict(family="nsf", dim=3, nlayers=2, hdims=(8, 8), K=5, B=4.0,
                fused=True, dtype="float64")
    ours, theirs = _train_cfg(tcfg, **flow), _train_cfg(jcfg, **flow)
    text = tcfg.config_to_json(ours)
    assert text == jcfg.config_to_json(theirs)
    assert tcfg.config_from_json(text) == ours
    assert tcfg.config_from_json(jcfg.config_to_json(theirs)) == ours
    assert jcfg.config_from_json(text) == theirs
    assert (tcfg.config_to_json(tcfg.TrainConfig())
            == jcfg.config_to_json(jcfg.TrainConfig()))
    assert tcfg.config_from_json(
        tcfg.config_to_json(tcfg.TrainConfig())) == tcfg.TrainConfig()
    sub = tcfg.config_from_json(tcfg.config_to_json(ours.flow),
                                tcfg.FlowConfig)
    assert sub == ours.flow and isinstance(sub.hdims, tuple)
    assert [f.name for f in dataclasses.fields(tcfg.TrainConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.TrainConfig)]


def _perturbed(tree, seed=0):
    """Every float leaf but a permutation's ``pmat``/``sign_s`` moved by
    noise of 0.1, off zero inits."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, v in leaves:
        key = jax.tree_util.keystr(path)
        if (isinstance(v, jax.Array) and jnp.issubdtype(v.dtype, jnp.floating)
                and not key.endswith(("pmat", "sign_s"))):
            v = v + 0.1 * jnp.asarray(rng.standard_normal(v.shape), v.dtype)
        out.append(v)
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_json_builds_the_equal_flow(family):
    """A JAX-written FlowConfig JSON builds a torch flow that the JAX
    flow's parameters fill, with JAX's log_prob (float64, rtol 1e-9)."""
    dim = 2 if family == "hamiltonian" else 3
    jc = jcfg.FlowConfig(family=family, dim=dim, nlayers=2, hdims=(8, 8),
                         K=5, B=4.0, dtype="float64")
    kw, tkw = {}, {}
    if family == "hamiltonian":
        kw = dict(score_fn=nf.Funnel(2, 0.0, 3.0).score)
        tkw = dict(score_fn=nft.Funnel(2, 0.0, 3.0).score)
    jflow = _perturbed(jc.build(jax.random.key(0), **kw))
    tc = tcfg.config_from_json(jcfg.config_to_json(jc), tcfg.FlowConfig)
    tflow = tc.build(torch.Generator().manual_seed(1), device="cpu", **tkw)
    load_jax_params(tflow, jax_arrays(jflow))
    assert all(p.dtype == torch.float64 for p in tflow.parameters())
    x = 0.5 * np.random.default_rng(2).standard_normal((16,
                                                        tflow.event_dim))
    with torch.no_grad():
        got = tflow.log_prob(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jflow.log_prob(x)),
                               rtol=1e-9, atol=1e-12)


def test_build_checks():
    """hamiltonian needs score_fn; an unknown family or dtype raises;
    bfloat16 builds every family (nsf and fused realnvp on the kernels'
    bfloat16 instantiations); device=None without a card raises."""
    with pytest.raises(ValueError, match="score"):
        tcfg.FlowConfig(family="hamiltonian").build(torch.Generator(),
                                                    device="cpu")
    with pytest.raises(ValueError, match="family"):
        tcfg.FlowConfig(family="spline").build(torch.Generator(),
                                               device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        tcfg.FlowConfig(dtype="float16").build(torch.Generator(),
                                               device="cpu")
    # bfloat16 nsf and fused realnvp, which raised until the kernels had
    # bfloat16 instantiations, build in bfloat16 and give the log_prob of
    # the same float32-widened flow within 2^-7 relative (a few bfloat16
    # roundings)
    x = torch.randn((16, 2), generator=torch.Generator().manual_seed(3))
    for kw in (dict(family="nsf", B=4.0), dict(family="realnvp",
                                                 fused=True)):
        cfg = tcfg.FlowConfig(dtype="bfloat16", nlayers=2, hdims=(8, 8),
                              **kw)
        flow = cfg.build(torch.Generator().manual_seed(0), device="cpu")
        assert {p.dtype for p in flow.parameters()} == {torch.bfloat16}
        wide = dataclasses.replace(cfg, dtype="float32").build(
            torch.Generator(), device="cpu")
        wide.load_state_dict({k: v.float()
                              for k, v in flow.state_dict().items()})
        lp = flow.log_prob(x.to(torch.bfloat16)).float()
        lp32 = wide.log_prob(x.to(torch.bfloat16).float())
        assert float(((lp - lp32).abs() / (lp32.abs() + 1)).max()) < 2 ** -7
    flow = tcfg.FlowConfig(family="planar", dtype="bfloat16").build(
        torch.Generator(), device="cpu")
    assert {p.dtype for p in flow.parameters()} == {torch.bfloat16}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcfg.FlowConfig().build(torch.Generator())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcfg.TrainConfig().generators()


def test_optimizers_and_objectives():
    params = [torch.nn.Parameter(torch.ones(2))]
    for name, cls in (("adam", torch.optim.Adam), ("sgd", torch.optim.SGD),
                      ("adamw", torch.optim.AdamW)):
        opt = tcfg.OptimizerConfig(name=name, learning_rate=0.1).build()(
            params)
        assert type(opt) is cls and opt.param_groups[0]["lr"] == 0.1
    with pytest.raises(ValueError, match="optimizer"):
        tcfg.OptimizerConfig(name="lbfgs").build()
    with pytest.raises(ValueError, match="objective"):
        tcfg.TrainConfig(objective="loglikelihood").run(
            lambda x: x.sum(), device="cpu")
    with pytest.raises(ValueError, match="target_logp"):
        tcfg.TrainConfig().run(device="cpu")
    with pytest.raises(ValueError, match="needs data"):
        tcfg.TrainConfig(objective="mle").run(device="cpu")


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_run_improves_the_elbo(optimizer):
    """A JAX-written JSON (``unroll=4`` read and not used) trains on the
    CPU: the ELBO of the last 20 steps beats the first 20's."""
    target = nft.Banana(2, 1.0, 10.0)
    jc = jcfg.TrainConfig(
        flow=jcfg.FlowConfig(family="realnvp", dim=2, nlayers=2,
                             hdims=(8, 8), dtype="float64"),
        optimizer=jcfg.OptimizerConfig(name=optimizer, learning_rate=1e-2),
        max_iters=300, n_samples=32, check_every=100, seed=0, unroll=4)
    cfg = tcfg.config_from_json(jcfg.config_to_json(jc))
    assert cfg.unroll == 4
    res = cfg.run(target.log_prob, device="cpu")
    loss = res.stats["loss"]
    assert loss.shape == (300,) and np.all(np.isfinite(loss))
    assert loss[-20:].mean() < loss[:20].mean()
    again = cfg.run(target.log_prob, device="cpu", max_iters=10)
    np.testing.assert_array_equal(again.stats["loss"], loss[:10])


def _mle_cfg(**kw):
    return tcfg.TrainConfig(
        flow=tcfg.FlowConfig(family="realnvp", dim=2, nlayers=2,
                             hdims=(8, 8), dtype="float64"),
        objective="mle", max_iters=10, check_every=5, batch_size=32, seed=3,
        **kw)


def test_mle_from_an_array_a_npy_and_a_raw_file(tmp_path):
    """An array and its .npy give the same run (`NumpyLoader`); a raw
    float32 file goes through `NativeLoader` with the flow's dim, the
    rows from its size and the config's seed."""
    arr = np.asarray(nf.Banana(2, 1.0, 10.0).sample(jax.random.key(2),
                                                    (500,)), np.float32)
    np.save(tmp_path / "d.npy", arr)
    raw = data.to_raw_file(str(tmp_path / "d.f32"), arr)
    a = _mle_cfg().run(data=arr, device="cpu").stats["loss"]
    b = _mle_cfg(data_path=str(tmp_path / "d.npy")).run(
        device="cpu").stats["loss"]
    np.testing.assert_array_equal(a, b)
    cfg = _mle_cfg(data_path=raw)
    c = cfg.run(device="cpu").stats["loss"]
    assert c.shape == (10,) and np.all(np.isfinite(c))
    flow = cfg.flow.build(cfg.generators("cpu")[0], device="cpu")
    loader = data.NativeLoader(raw, 500, 2, 32, seed=3)
    want = nft.train_flow_mle(flow, loader, max_iters=10, check_every=5,
                              optimizer=cfg.optimizer.build())
    loader.close()
    np.testing.assert_array_equal(c, want.stats["loss"])
    assert not np.array_equal(a, c)


def test_mle_run_follows_jax():
    """JAX `TrainConfig.run(data=...)` against the port's on the same
    loader batches (seed 0) from the JAX run's initial weights, bridged:
    per-step losses and final parameters, float32 (the JAX suite's
    training tolerances). Float32 only: the loaders yield float32, which
    a float64 JAX flow's scan refuses as its carry."""
    dt, tol = "float32", (1e-4, 1e-5)
    arr = np.asarray(nf.Banana(2, 1.0, 10.0).sample(jax.random.key(4),
                                                    (400,)), np.float32)
    jc = jcfg.TrainConfig(
        flow=jcfg.FlowConfig(family="realnvp", dim=2, nlayers=2,
                             hdims=(8, 8), dtype=dt),
        optimizer=jcfg.OptimizerConfig(learning_rate=1e-2),
        objective="mle", max_iters=12, check_every=5, batch_size=64, seed=0)
    kb, _ = jax.random.split(jax.random.key(jc.seed))
    jflow0 = jc.flow.build(kb)
    jres = jc.run(data=arr)

    cfg = tcfg.config_from_json(jcfg.config_to_json(jc))
    tflow = cfg.flow.build(torch.Generator(), device="cpu")
    load_jax_params(tflow, jax_arrays(jflow0))
    start = TrainState(tflow, cfg.optimizer.build()(
        trainable_parameters(tflow)), 0)
    tres = cfg.run(data=arr, device="cpu", resume_state=start)
    np.testing.assert_allclose(tres.stats["loss"],
                               np.asarray(jres.stats["loss"]), rtol=tol[0],
                               atol=tol[1])
    ref = jax_arrays(jres.flow)
    check = tcfg.FlowConfig(**dataclasses.asdict(cfg.flow)).build(
        torch.Generator(), device="cpu")
    load_jax_params(check, ref)
    for (name, p), q in zip(tflow.named_parameters(), check.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=tol[0], atol=tol[1], err_msg=name)
