"""The port's training step body, the launch counters and the mask indices.

(a) The eager run of the one step body that the CUDA graph also captures
(``graph=False``, and ``graph=None`` on a CPU flow) against the JAX
package's own `train_flow` and `train_flow_mle` on the same draws and
batches, chunk by chunk. Tolerances are
`tests/test_torch_train.py`'s: f64 rtol 1e-8 (atol 1e-12), f32 rtol 1e-4
(atol 1e-5), on per-step losses, gradient norms and final parameters.
(b) What a graph refuses on the CPU. (c) `ops/launches.py`'s accounting,
and the graphed schedule of `train._Steps` (warm steps, one capture,
replays) with stub CUDA objects: a stub records nothing, so this checks the
schedule and the counts, not a capture (the card's `chip_smoke.py` does).
(d) The cached index tensors of a non-strided mask.
"""

import contextlib
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch import train as port_train  # noqa: E402
from normalizingflows_torch.ops import launches  # noqa: E402
from normalizingflows_torch.ops.masks import PartitionMask  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402

torch.set_num_threads(1)

DIM, HDIMS, NLAYERS, BATCH, LR = 4, (16, 16), 2, 32, 5e-4
STEPS, CHECK = 4, 2  # two chunks: one compile of the JAX scan
DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": (1e-4, 1e-5), "f64": (1e-8, 1e-12)}


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _flows(dt, seed=0):
    """A JAX nsf (the oracle backend) off the identity by noise of 0.1 on
    every parameter, and the port's copy of it on the CPU."""
    jdt, tdt, _ = DT[dt]
    jflow = nf.nsf(jax.random.key(seed), DIM, HDIMS, K=10, B=4.0,
                   nlayers=NLAYERS, dtype=jdt, backend="oracle",
                   identity_init=True)
    rng = np.random.default_rng(seed + 1)
    jflow = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                        a.dtype), jflow)
    tflow = nft.nsf(torch.Generator().manual_seed(seed), DIM, HDIMS, K=10,
                    B=4.0, nlayers=NLAYERS, dtype=tdt, device="cpu")
    load_jax_params(tflow, jax_arrays(jflow))
    return jflow, tflow


def _chunk_draws(key, dt):
    """The base draws JAX `train_flow` makes with ``scan_inputs`` below:
    one split of the run's key a chunk."""
    out = []
    for chunk in (CHECK,) * (STEPS // CHECK):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (chunk, BATCH, DIM),
                                                DT[dt][0])))
    return np.concatenate(out)


def _presampled(draws):
    """``scan_inputs`` handing the port the given draws, chunk by chunk."""
    draws = torch.from_numpy(draws)
    pos = [0]

    def gen(generator, flow, chunk):
        out = draws[pos[0]:pos[0] + chunk]
        pos[0] += chunk
        return out

    return gen


class _Batches:
    """A loader over fixed batches: ``next_batches(k)`` hands out the next
    k, as numpy, to either package."""

    def __init__(self, data):
        self.data, self.pos = data, 0

    def next_batches(self, k):
        out = self.data[self.pos:self.pos + k]
        self.pos += k
        return out


def _check(res, losses, gnorms, jflow, tflow, dt):
    rtol, atol = TOL[dt]
    np.testing.assert_array_equal(res.stats["iteration"],
                                  np.arange(1, STEPS + 1))
    np.testing.assert_allclose(res.stats["loss"], losses, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(res.stats["gradient_norm"], gnorms,
                               rtol=rtol, atol=atol)
    ref = dict(load_jax_params(
        nft.nsf(torch.Generator(), DIM, HDIMS, K=10, B=4.0, nlayers=NLAYERS,
                dtype=DT[dt][1], device="cpu"),
        jax_arrays(jflow)).named_parameters())
    for name, p in tflow.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


# (a) the eager step body against JAX train_flow / train_flow_mle
@pytest.mark.parametrize("dt,graph", [("f64", False), ("f32", None)])
def test_train_flow_steps_match_jax(dt, graph):
    jflow, tflow = _flows(dt)
    key = jax.random.key(11)
    jdt = DT[dt][0]
    jres = nf.train_flow(
        key, lambda xs, f, lp: nf.elbo_from_samples(xs, f, lp), jflow,
        nf.Banana(DIM, 1.0, 100.0).log_prob, max_iters=STEPS,
        check_every=CHECK, optimizer=optax.adam(LR),
        scan_inputs=lambda k, f, n: jax.random.normal(k, (n, BATCH, DIM),
                                                      jdt))
    target = nft.Banana(DIM, 1.0, 100.0)
    res = nft.train_flow(
        torch.Generator(), nft.elbo_from_samples, tflow, target.log_prob,
        max_iters=STEPS, check_every=CHECK,
        optimizer=lambda p: torch.optim.Adam(p, lr=LR),
        scan_inputs=_presampled(_chunk_draws(key, dt)), graph=graph)
    _check(res, jres.stats["loss"], jres.stats["gradient_norm"], jres.flow,
           tflow, dt)


@pytest.mark.parametrize("dt,graph", [("f64", None), ("f32", False)])
def test_train_flow_mle_steps_match_jax(dt, graph):
    jflow, tflow = _flows(dt, seed=2)
    data = nf.Banana(DIM, 1.0, 10.0).sample(
        jax.random.key(5), (STEPS * 16,)).reshape(STEPS, 16, DIM)
    data = np.array(data, DT[dt][2])
    jres = nf.train_flow_mle(jflow, _Batches(data), max_iters=STEPS,
                             check_every=CHECK, optimizer=optax.adam(LR))
    res = nft.train_flow_mle(tflow, _Batches(data), max_iters=STEPS,
                             check_every=CHECK,
                             optimizer=lambda p: torch.optim.Adam(p, lr=LR),
                             graph=graph)
    _check(res, jres.stats["loss"], jres.stats["gradient_norm"], jres.flow,
           tflow, dt)


# (b) what a graph refuses
def test_graph_on_a_cpu_flow_raises():
    _, tflow = _flows("f64")
    target = nft.Banana(DIM, 1.0, 100.0)
    before = [p.detach().clone() for p in tflow.parameters()]
    for train in (
            lambda: nft.train_flow(torch.Generator(), nft.elbo_batch, tflow,
                                   target.log_prob, BATCH, max_iters=2,
                                   graph=True),
            lambda: nft.train_flow_mle(tflow, _Batches(np.zeros(
                (2, 8, DIM))), max_iters=2, graph=True)):
        with pytest.raises(ValueError, match="CUDA device"):
            train()
    # nothing ran
    for a, b in zip(tflow.parameters(), before):
        assert torch.equal(a, b)


def test_graph_needs_a_capturable_optimizer():
    """An optimizer with a host-side step count and no capturable mode
    (Adagrad) is refused under a graph; SGD, which keeps no step count, is
    taken (here it then meets the CPU) and not made capturable."""
    _, tflow = _flows("f64")
    target = nft.Banana(DIM, 1.0, 100.0)
    with pytest.raises(TypeError, match="capturable.*graph=False"):
        nft.train_flow(torch.Generator(), nft.elbo_batch, tflow,
                       target.log_prob, BATCH, max_iters=2, graph=True,
                       optimizer=lambda p: torch.optim.Adagrad(p, lr=0.1))
    made = []
    with pytest.raises(ValueError, match="CUDA device"):
        nft.train_flow(torch.Generator(), nft.elbo_batch, tflow,
                       target.log_prob, BATCH, max_iters=2, graph=True,
                       optimizer=lambda p: made.append(
                           torch.optim.SGD(p, lr=0.1)) or made[-1])
    assert "capturable" not in made[0].param_groups[0]


def test_graph_takes_only_tensor_inputs():
    steps = port_train._Steps(lambda inp: None, torch.device("cpu"), 4,
                              graphed=True)
    with pytest.raises(TypeError, match="tensor.*graph=False"):
        steps._fetch(2, [object(), object()])
    with pytest.raises(ValueError, match="inputs shaped"):
        steps._fetch(3, torch.zeros(2, 5))


def test_make_capturable_moves_eager_step_counts():
    """An optimizer that ran eagerly resumes under a graph: capturable on
    in every group, its step counts on the parameters' device."""
    w = torch.nn.Parameter(torch.ones(3, dtype=torch.float64))
    opt = torch.optim.AdamW([w], lr=0.1)
    w.sum().backward()
    opt.step()
    port_train._make_capturable(opt)
    assert all(g["capturable"] for g in opt.param_groups)
    assert opt.state[w]["step"].device == w.device


# (c) launch accounting
class _StubGraph:
    def __init__(self):
        self.replays, self.generators = 0, []

    def replay(self):
        self.replays += 1

    def register_generator_state(self, generator):
        self.generators.append(generator)


def test_launch_counts_count_replays_not_captures():
    launches.reset()
    assert launches.counts() == dict.fromkeys(launches.KERNELS, 0)
    launches.count("rqs_fwd")
    graph = launches.CountedGraph(_StubGraph())
    with graph.capture(contextlib.nullcontext()):
        launches.count("rqs_fwd")
        launches.count("rqs_bwd_fwddir")
        launches.count("rqs_bwd_fwddir")
    # the capture executed nothing: its counts are taken back
    assert launches.counts()["rqs_fwd"] == 1
    assert launches.counts()["rqs_bwd_fwddir"] == 0
    assert launches.captures() == 1
    assert graph.per_replay == {**dict.fromkeys(launches.KERNELS, 0),
                                "rqs_fwd": 1, "rqs_bwd_fwddir": 2}
    for _ in range(3):
        graph.replay()
    assert graph.graph.replays == 3
    assert launches.counts() == {**dict.fromkeys(launches.KERNELS, 0),
                                 "rqs_fwd": 4, "rqs_bwd_fwddir": 6}
    # a capture that fails takes its counts back too
    failed = launches.CountedGraph(_StubGraph())
    with pytest.raises(RuntimeError, match="capture failed"):
        with failed.capture(contextlib.nullcontext()):
            launches.count("coupling_fwd")
            raise RuntimeError("capture failed")
    assert launches.counts()["coupling_fwd"] == 0
    with pytest.raises(KeyError):
        launches.count("no_such_kernel")
    launches.reset()
    assert launches.counts() == dict.fromkeys(launches.KERNELS, 0)
    assert launches.captures() == 0


def _stub_cuda(monkeypatch):
    """torch.cuda's streams, devices and graphs as no-ops on the CPU."""
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    graphs = []

    def new_graph():
        graphs.append(_StubGraph())
        return graphs[-1]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    port_train._side_stream.cache_clear()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return graphs


def test_graphed_schedule_counts_every_step_once(monkeypatch):
    """Chunks of 2, 4 and 2 steps: the first chunk is all warm steps, the
    second one more warm step, the capture and 3 replays, the third 2
    replays and no second capture. A step body launching one K1 leaves
    the count at the run's 8 steps; the generator is registered."""
    graphs = _stub_cuda(monkeypatch)
    generator = torch.Generator()
    ran = []

    def body(inp):
        assert inp is generator
        ran.append(1)
        launches.count("rqs_fwd")
        return torch.ones(()), torch.ones(())

    launches.reset()
    steps = port_train._Steps(body, torch.device("cpu"), 4, graphed=True,
                              generator=generator)
    for chunk, replays in ((2, 0), (4, 3), (2, 5)):
        losses, gnorms = steps.run(chunk, None)
        assert losses.shape == gnorms.shape == (chunk,)
        assert sum(g.replays for g in graphs) == replays
    assert len(graphs) == 1 and launches.captures() == 1
    assert graphs[0].generators == [generator]
    # 3 warm steps and the capture ran the body; replays do not
    assert len(ran) == port_train.WARM_STEPS + 1
    assert launches.counts()["rqs_fwd"] == 8
    port_train._side_stream.cache_clear()


# (d) cached mask indices
def test_non_strided_mask_caches_its_indices(monkeypatch):
    mask = PartitionMask.make(6, (0, 1, 4))  # not an evenly strided set
    x = torch.arange(12.0, dtype=torch.float64).reshape(2, 6)
    a, b, c = mask.partition(x)
    assert torch.equal(a, x[:, [0, 1, 4]])
    assert torch.equal(b, x[:, [2, 3, 5]])
    assert c.shape == (2, 0)
    assert torch.equal(mask.combine(a, b, c), x)

    def no_copy(*args, **kw):
        raise AssertionError("a host→device index copy after the first call")

    monkeypatch.setattr(torch, "tensor", no_copy)
    a2, b2, _ = mask.partition(x)
    assert torch.equal(a2, a) and torch.equal(b2, b)
    assert torch.equal(mask.combine(a2, b2, c), x)
