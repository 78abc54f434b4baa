"""The port's checkpoints: round trips, the exact resume, mismatches, the
atomic write, and JAX ``.npz`` checkpoints read into the port.

The JAX suite's resume contract (tests/test_checkpoint.py:88-128): 200
steps against 100 steps → save → load into a fresh flow, optimizer and
generator → 100 steps give identical bits in the losses, the final
parameters and the optimizer state. The port's generator state takes the
place of JAX's advanced key. A JAX checkpoint read into the port takes one
more Adam step on the same draws as JAX does, to rtol 1e-9 in float64.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
from normalizingflows.jl_tpu.utils.pytree import (  # noqa: E402
    apply_mask,
    trainable_mask,
)
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.train import TrainState  # noqa: E402
from normalizingflows_torch.utils import checkpoint as ckpt  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402
from normalizingflows_torch.utils.pytree import (  # noqa: E402
    trainable_parameters,
)

torch.set_num_threads(1)


def jax_paths(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [jax.tree_util.keystr(p) for p, _ in leaves]


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


FLOWS = {
    "nsf": lambda g, dt: nft.nsf(g, 3, (8, 8), K=5, B=4.0, nlayers=2,
                                 dtype=dt, device="cpu"),
    "realnvp": lambda g, dt: nft.realnvp(g, 3, (8, 8), nlayers=2, dtype=dt,
                                         device="cpu"),
    "realnvp_fused": lambda g, dt: nft.realnvp(g, 3, (8, 8), nlayers=2,
                                               dtype=dt, device="cpu",
                                               fused=True),
    "glow": lambda g, dt: nft.glow(g, 3, (8, 8), nlayers=2, dtype=dt,
                                   device="cpu", mix_seed=int(g.seed())),
    "maf": lambda g, dt: nft.maf(g, 3, (8, 8), nlayers=2, dtype=dt,
                                 device="cpu"),
}


def _flow(kind, seed, dt=torch.float64):
    return FLOWS[kind](torch.Generator().manual_seed(seed), dt)


@pytest.mark.parametrize("kind", sorted(FLOWS))
def test_flow_round_trip(tmp_path, kind):
    """A flow saved and loaded into one of another seed has its tensors
    (glow's ``pmat``/``sign_s`` buffers too) and its log_prob bit for bit;
    `load_pytree` reads a train state's flow as well."""
    src, dst = _flow(kind, 0), _flow(kind, 1)
    with torch.no_grad():
        for p in src.parameters():  # off any zero init
            p.add_(0.1 * torch.randn(p.shape, dtype=p.dtype,
                                     generator=torch.Generator().manual_seed(
                                         p.numel())))
    path = str(tmp_path / "flow.pt")
    ckpt.save_pytree(path, src)
    assert ckpt.load_pytree(path, dst) is dst
    for (k, a), (k2, b) in zip(src.state_dict().items(),
                               dst.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    if kind == "glow":
        assert {"pmat", "sign_s"} <= {k.rsplit(".", 1)[-1]
                                      for k in dst.state_dict()}
    x = torch.randn(16, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(src.log_prob(x), dst.log_prob(x))
    opt = torch.optim.Adam(trainable_parameters(src), lr=1e-3)
    ckpt.save_train_state(path, TrainState(src, opt, 7))
    third = ckpt.load_pytree(path, _flow(kind, 2))
    with torch.no_grad():
        assert torch.equal(third.log_prob(x), src.log_prob(x))


def _adam_state(opt):
    return [(k, v) for s in opt.state_dict()["state"].values()
            for k, v in sorted(s.items())]


@pytest.mark.parametrize("kind,dt", [("nsf", torch.float64),
                                     ("realnvp_fused", torch.float32)])
def test_resume_trajectory_bitwise(tmp_path, kind, dt):
    """200 steps against 100 → save_train_state (with the generator) → a
    fresh flow, optimizer and generator → load_train_state → 100: the
    losses, final parameters, Adam state and generator state agree bit
    for bit."""
    target = nft.Banana(3, 1.0, 10.0)

    def run(flow, gen, steps, state=None):
        return nft.train_flow(
            gen, nft.elbo_batch, flow, target.log_prob, 8, max_iters=steps,
            check_every=50, resume_state=state,
            optimizer=lambda p: torch.optim.Adam(p, lr=1e-2))

    gen_a = torch.Generator().manual_seed(3)
    res_a = run(_flow(kind, 0, dt), gen_a, 200)

    gen_b = torch.Generator().manual_seed(3)
    res_b1 = run(_flow(kind, 0, dt), gen_b, 100)
    path = str(tmp_path / "state.pt")
    ckpt.save_train_state(path, res_b1.state, generator=gen_b)

    fresh = _flow(kind, 9, dt)
    template = TrainState(fresh, torch.optim.Adam(
        trainable_parameters(fresh), lr=0.5), 0)
    gen_c = torch.Generator().manual_seed(11)
    state = ckpt.load_train_state(path, template, generator=gen_c)
    assert state.iteration == 100 and state.flow is fresh
    assert state.opt_state.param_groups[0]["lr"] == 1e-2
    assert all(s["step"].device.type == "cpu"
               for s in state.opt_state.state.values())
    res_b2 = run(fresh, gen_c, 100, state)

    assert res_b2.state.iteration == 200
    np.testing.assert_array_equal(
        np.concatenate([res_b1.stats["loss"], res_b2.stats["loss"]]),
        res_a.stats["loss"])
    for a, b in zip(res_a.flow.state_dict().values(),
                    res_b2.flow.state_dict().values()):
        assert torch.equal(a, b)
    for (ka, a), (kb, b) in zip(_adam_state(res_a.state.opt_state),
                                _adam_state(res_b2.state.opt_state)):
        assert ka == kb and torch.equal(a, b), ka
    assert torch.equal(gen_a.get_state(), gen_c.get_state())


def test_mismatched_template_raises(tmp_path):
    flow = _flow("realnvp", 0)
    opt = torch.optim.Adam(trainable_parameters(flow), lr=1e-3)
    path, flow_only = str(tmp_path / "s.pt"), str(tmp_path / "f.pt")
    ckpt.save_train_state(path, TrainState(flow, opt, 3))
    ckpt.save_pytree(flow_only, flow)
    deeper = nft.realnvp(torch.Generator(), 3, (8, 8), nlayers=3,
                         dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        ckpt.load_pytree(path, deeper)
    wider = nft.realnvp(torch.Generator(), 3, (8, 9), nlayers=2,
                        dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_pytree(path, wider)
    other = _flow("realnvp", 1)
    half = torch.optim.Adam(trainable_parameters(other)[:3], lr=1e-3)
    with pytest.raises(ValueError, match="group"):
        ckpt.load_train_state(path, TrainState(other, half, 0))
    with pytest.raises(ValueError, match="not a train state"):
        ckpt.load_train_state(flow_only, TrainState(other, opt, 0))
    with pytest.raises(ValueError, match="without a generator"):
        ckpt.load_train_state(path, TrainState(other, torch.optim.Adam(
            trainable_parameters(other)), 0), generator=torch.Generator())
    with pytest.raises(ValueError, match="dcp"):
        ckpt.save_pytree(str(tmp_path / "o"), flow, backend="orbax")


def test_dcp_round_trip_on_one_process(tmp_path):
    """``backend="dcp"`` without a process group: a dict of a flow (glow's
    buffers too) and a nested tensor is loaded in place into a template of
    another seed bit for bit; a train state keeps ``"torch"`` only."""
    src, dst = _flow("glow", 0), _flow("glow", 1)
    data, into = torch.randn(6, 3, dtype=torch.float64), torch.zeros(6, 3)
    path = str(tmp_path / "dcp")
    ckpt.save_pytree(path, {"flow": src, "more": {"data": data}},
                     backend="dcp")
    template = {"flow": dst, "more": {"data": into.double()}}
    out = ckpt.load_pytree(path, template, backend="dcp")
    assert out is template and out["flow"] is dst
    for (k, a), b in zip(src.state_dict().items(),
                         dst.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(template["more"]["data"], data)
    opt = torch.optim.Adam(trainable_parameters(src), lr=1e-3)
    with pytest.raises(ValueError, match="takes torch"):
        ckpt.save_train_state(str(tmp_path / "s"), TrainState(src, opt, 0),
                              backend="dcp")
    with pytest.raises(ValueError, match="takes torch"):
        ckpt.load_train_state(str(tmp_path / "s"), TrainState(src, opt, 0),
                              backend="dcp")
    with pytest.raises(TypeError, match="module or a dict"):
        ckpt.save_pytree(path, [src], backend="dcp")


def test_atomic_write(tmp_path, monkeypatch):
    """A save that fails midway leaves the last checkpoint whole: the file
    is written to ``.tmp`` and moved over the old one only when done."""
    path = str(tmp_path / "flow.pt")
    flow = _flow("maf", 0)
    ckpt.save_pytree(path, flow)
    before = (tmp_path / "flow.pt").read_bytes()

    def torn(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_pytree(path, _flow("maf", 1))
    assert (tmp_path / "flow.pt").read_bytes() == before
    assert (tmp_path / "flow.pt.tmp").read_bytes() == b"partial"
    monkeypatch.undo()
    ckpt.load_pytree(path, _flow("maf", 2))


def _jax_run(steps=5, lr=1e-3):
    """A JAX float64 realnvp trained ``steps`` steps: its TrainState."""
    flow = nf.realnvp(jax.random.key(0), 3, (8, 8), nlayers=2,
                      dtype=jnp.float64)
    res = nf.train_flow(jax.random.key(1), nf.elbo_batch, flow,
                        nf.Banana(3, 1.0, 10.0).log_prob, 8,
                        max_iters=steps, check_every=steps,
                        optimizer=optax.adam(lr))
    return res.state


def _port_flow():
    return nft.realnvp(torch.Generator().manual_seed(5), 3, (8, 8),
                       nlayers=2, dtype=torch.float64, device="cpu")


def test_reads_a_jax_flow_checkpoint(tmp_path):
    state = _jax_run()
    path = str(tmp_path / "flow.npz")
    jax_ckpt.save_pytree(path, state.flow)
    tflow = ckpt.load_jax_checkpoint(path, _port_flow(),
                                     jax_paths(state.flow))
    x = np.random.default_rng(0).standard_normal((32, 3))
    with torch.no_grad():
        got = tflow.log_prob(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(state.flow.log_prob(x)),
                               rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_jax_checkpoint(path, _port_flow(),
                                 jax_paths(state.flow)[1:])


def test_reads_a_jax_train_state_and_steps_alike(tmp_path):
    """`save_train_state` of JAX (flow, optax.adam state, iteration) into
    the port's flow and Adam: one more step on the same draws gives JAX's
    parameters and moments to rtol 1e-9 (float64)."""
    lr = 1e-3
    state = _jax_run(lr=lr)
    path = str(tmp_path / "state.npz")
    jax_ckpt.save_train_state(path, state)
    paths = jax_paths((state.flow, state.opt_state, state.iteration))

    tflow = _port_flow()
    opt = torch.optim.Adam(trainable_parameters(tflow), lr=lr)
    tstate = ckpt.load_jax_checkpoint(path, tflow, paths, optimizer=opt)
    assert isinstance(tstate.iteration, int) and tstate.iteration == 5
    assert tstate.flow is tflow and tstate.opt_state is opt
    assert {float(s["step"]) for s in opt.state.values()} == {5.0}

    xs = np.random.default_rng(3).standard_normal((1, 16, 3))
    target = nf.Banana(3, 1.0, 10.0)
    flow = jax_ckpt.load_train_state(path, state).flow
    optimizer = optax.adam(lr)
    mask = trainable_mask(flow, frozen=lambda m: m is flow.base)
    grads = jax.grad(lambda f: -nf.elbo_from_samples(
        jnp.asarray(xs[0]), f, target.log_prob))(flow)
    updates, jst = optimizer.update(apply_mask(grads, mask),
                                    state.opt_state, flow)
    jflow = optax.apply_updates(flow, updates)

    ttarget = nft.Banana(3, 1.0, 10.0)
    res = nft.train_flow(
        torch.Generator(), lambda x, f, lp: nft.elbo_from_samples(x, f, lp),
        tflow, ttarget.log_prob, max_iters=1, resume_state=tstate,
        scan_inputs=lambda g, f, n: torch.from_numpy(xs[:n]))
    assert res.state.iteration == 6
    ref = dict(load_jax_params(copy.deepcopy(tflow),
                               jax_arrays(jflow)).named_parameters())
    mu = dict(load_jax_params(copy.deepcopy(tflow),
                              jax_arrays(jst[0].mu)).named_parameters())
    names = {id(p): n for n, p in tflow.named_parameters()}
    for p in trainable_parameters(tflow):
        name = names[id(p)]
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=name)
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(),
                                   mu[name].detach().numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=name)
