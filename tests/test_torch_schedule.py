"""The port's learning-rate schedule inside the step (`optim.py`).

The port computes the schedule in float64 and rounds it to the count's
dtype, the parameters' in `optim.adam`. optax computes it from its int32
count, in float32 with or without x64; the float64 cases below give optax
that count as float64 (x64), whose values are float64.

(a) `warmup_cosine_decay_schedule` against `optax.warmup_cosine_decay_schedule`
at every count from 0 to ``decay_steps + 50``, with and without x64, for the
parity row's parameters, the NSF demo's, an exponent of 2 and a peak of 0.
(b) 10 Adam steps of `nsf(affine_wrap=True, identity_init=True)` under the
schedule against JAX `train_flow` with ``optax.adam(schedule)`` on the same
draws: losses, gradient norms, parameters and both Adam moments, float64
to rtol 1e-9 and float32 to the JAX suite's 1e-4; the first step (rate 0)
leaves the parameters unchanged. (c) A scheduled run resumed from
`save_train_state` gives the straight run's bits. (d) A JAX ``.npz`` train
state of a scheduled Adam read by `load_jax_checkpoint`, and one more step
on both sides. (e) Under the trainers' graph (stub CUDA objects, as in
`tests/test_torch_graph_train.py`), a float rate a callback changes raises.
"""

import contextlib
import copy
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.train import (  # noqa: E402
    apply_mask,
    trainable_mask,
)
from normalizingflows.jl_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch import optim  # noqa: E402
from normalizingflows_torch import train as port_train  # noqa: E402
from normalizingflows_torch.utils import checkpoint as ckpt  # noqa: E402
from normalizingflows_torch.utils.bridge import load_jax_params  # noqa: E402
from normalizingflows_torch.utils.pytree import (  # noqa: E402
    trainable_parameters,
)

torch.set_num_threads(1)

DIM, HDIMS, NLAYERS, BATCH, BOX = 2, (16, 16), 2, 32, 4.0
STEPS, CHECK = 10, 5
DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}
TOL = {"f32": (1e-4, 1e-5), "f64": (1e-9, 1e-12)}
# (init, peak, warmup, decay, end, exponent): the parity row's
# (benchmarks/parity.py:237-241), the NSF demo's at 400 steps
# (warmup = max_iters // 4 + 1), an exponent of 2, a peak of 0
SCHEDULES = [(0.0, 5e-4, 500, 50_000, 1e-5, 1.0),
             (0.0, 5e-4, 400 // 4 + 1, 400, 1e-5, 1.0),
             (1e-4, 3e-3, 7, 60, 1e-6, 2.0),
             (0.1, 0.0, 5, 40, 0.0, 1.0)]
# the training runs' schedule: 4 warmup steps, then the decay
TRAIN_SCHED = (0.0, 1e-2, 4, STEPS, 1e-4)


def jax_arrays(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def jax_paths(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [jax.tree_util.keystr(p) for p, _ in leaves]


# (a) the schedule against optax
@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("params", SCHEDULES, ids=["parity", "demo",
                                                    "exponent2", "peak0"])
def test_schedule_matches_optax(params, x64):
    """optax computes from an int32 count, in float32 with or without x64;
    with x64 a float64 count gives its float64 values. The port's schedule
    on a float32 (float64) count agrees within 4 ulps of the peak (the
    rounding of optax's float32 chain, eager or fused by XLA, against the
    port's float64 one rounded once), and returns the same dtype."""
    sched = optim.warmup_cosine_decay_schedule(*params)
    ref = optax.warmup_cosine_decay_schedule(*params)
    counts = np.arange(params[3] + 51)
    scale = max(abs(params[0]), abs(params[1]))
    cases = [(jnp.int32, torch.float32, 2.0 ** -23)]
    if x64:
        cases.append((jnp.float64, torch.float64, 2.0 ** -52))
    with jax.enable_x64(x64):
        for jdt, tdt, ulp in cases:
            c = jnp.asarray(counts, jdt)
            got = sched(torch.as_tensor(counts, dtype=tdt)).numpy()
            for want in (np.asarray(jax.jit(jax.vmap(ref))(c)),
                         np.asarray(jax.vmap(ref)(c))):
                assert got.dtype == want.dtype
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=4 * ulp * scale)
    # the cosine's end value holds past decay_steps, the warmup's start
    # before 0
    assert float(sched(torch.tensor(params[3] + 10.0))) == pytest.approx(
        params[4], rel=1e-6, abs=1e-12)
    assert float(sched(torch.tensor(-3.0))) == pytest.approx(
        params[0] if params[2] > 0 else params[1], rel=1e-6)


def test_schedule_refuses_an_empty_decay():
    with pytest.raises(ValueError, match="decay_steps > warmup_steps"):
        optim.warmup_cosine_decay_schedule(0.0, 1e-3, 10, 10)
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, 10, 10)


# (b) scheduled Adam against JAX train_flow with optax.adam(schedule)
def _optax_schedule(params, dt):
    """optax's schedule as the port's `optim.adam` evaluates it for
    ``dt``'s parameters: on optax's own int32 count (float32 values) for
    float32, on that count as float64 (float64 values, x64) for float64."""
    sched = optax.warmup_cosine_decay_schedule(*params)
    if dt == "f32":
        return sched
    return lambda count: sched(jnp.asarray(count, jnp.float64))


def _flows(dt, seed=0):
    """A JAX nsf(affine_wrap=True, identity_init=True) (the oracle
    backend) off the identity by noise of 0.1, and the port's copy."""
    jdt, tdt, _ = DT[dt]
    jflow = nf.nsf(jax.random.key(seed), DIM, HDIMS, K=10, B=BOX,
                   nlayers=NLAYERS, dtype=jdt, backend="oracle",
                   identity_init=True, affine_wrap=True)
    rng = np.random.default_rng(seed + 1)
    jflow = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                        a.dtype), jflow)
    tflow = nft.nsf(torch.Generator().manual_seed(seed), DIM, HDIMS, K=10,
                    B=BOX, nlayers=NLAYERS, dtype=tdt, device="cpu",
                    identity_init=True, affine_wrap=True)
    load_jax_params(tflow, jax_arrays(jflow))
    return jflow, tflow


def _chunk_draws(key, dt):
    """The base draws JAX `train_flow` makes with ``scan_inputs``: one
    split of the run's key a chunk."""
    out = []
    for _ in range(STEPS // CHECK):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (CHECK, BATCH, DIM),
                                                DT[dt][0])))
    return np.concatenate(out)


def _presampled(draws):
    draws = torch.from_numpy(draws)
    pos = [0]

    def gen(generator, flow, chunk):
        out = draws[pos[0]:pos[0] + chunk]
        pos[0] += chunk
        return out

    return gen


def _by_name(tflow, jtree):
    """A JAX tree shaped like the flow (a moment) as the port's
    {parameter name: tensor}."""
    return dict(load_jax_params(copy.deepcopy(tflow),
                                jax_arrays(jtree)).named_parameters())


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_scheduled_adam_matches_jax(dt):
    jflow, tflow = _flows(dt)
    key = jax.random.key(11)
    jdt = DT[dt][0]
    jres = nf.train_flow(
        key, lambda xs, f, lp: nf.elbo_from_samples(xs, f, lp), jflow,
        nf.Banana(DIM, 1.0, 100.0).log_prob, max_iters=STEPS,
        check_every=CHECK,
        optimizer=optax.adam(_optax_schedule(TRAIN_SCHED, dt)),
        scan_inputs=lambda k, f, n: jax.random.normal(k, (n, BATCH, DIM),
                                                      jdt))
    before = {n: p.detach().clone() for n, p in tflow.named_parameters()}
    target = nft.Banana(DIM, 1.0, 100.0)
    draws = _chunk_draws(key, dt)
    one = nft.train_flow(
        torch.Generator(), nft.elbo_from_samples, copy.deepcopy(tflow),
        target.log_prob, max_iters=1, check_every=1,
        optimizer=optim.adam(optim.warmup_cosine_decay_schedule(
            *TRAIN_SCHED)), scan_inputs=_presampled(draws))
    # step 0 runs at sched(0) = 0: nothing moves
    for n, p in one.flow.named_parameters():
        assert torch.equal(p, before[n]), n
    res = nft.train_flow(
        torch.Generator(), nft.elbo_from_samples, tflow, target.log_prob,
        max_iters=STEPS, check_every=CHECK,
        optimizer=optim.adam(optim.warmup_cosine_decay_schedule(
            *TRAIN_SCHED)), scan_inputs=_presampled(draws))
    rtol, atol = TOL[dt]
    np.testing.assert_allclose(res.stats["loss"], jres.stats["loss"],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(res.stats["gradient_norm"],
                               jres.stats["gradient_norm"], rtol=rtol,
                               atol=atol)
    adam_state = jres.state.opt_state[0]
    ref = _by_name(tflow, jres.flow)
    mu, nu = _by_name(tflow, adam_state.mu), _by_name(tflow, adam_state.nu)
    opt = res.state.opt_state
    names = {id(p): n for n, p in tflow.named_parameters()}
    for p in trainable_parameters(tflow):
        n = names[id(p)]
        for got, want in ((p, ref[n]), (opt.state[p]["exp_avg"], mu[n]),
                          (opt.state[p]["exp_avg_sq"], nu[n])):
            np.testing.assert_allclose(got.detach().numpy(),
                                       want.detach().numpy(), rtol=rtol,
                                       atol=atol, err_msg=n)
    # the group's rate: a tensor in the parameters' dtype holding the
    # schedule's value at the last step's count
    lr = opt.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and lr.dtype == DT[dt][1]
    want = np.asarray(_optax_schedule(TRAIN_SCHED, dt)(jnp.int32(STEPS - 1)))
    assert want.dtype == DT[dt][2]
    np.testing.assert_allclose(float(lr), float(want), rtol=0,
                               atol=4 * np.finfo(want.dtype).eps
                               * TRAIN_SCHED[1])
    assert int(jres.state.opt_state[1].count) == STEPS


# (c) the exact resume under a schedule
def _port_flow(seed=0):
    return nft.nsf(torch.Generator().manual_seed(seed), DIM, HDIMS, K=10,
                   B=BOX, nlayers=NLAYERS, dtype=torch.float64, device="cpu",
                   identity_init=True, affine_wrap=True)


def test_scheduled_resume_bitwise(tmp_path):
    """40 steps against 20 → save_train_state → a fresh flow, optimizer and
    generator → load_train_state → 20: identical bits. The loaded
    optimizer holds another lr tensor than the one it was built with; a
    hook that wrote into its own tensor would train the resumed half at
    the checkpoint's rate."""
    sched = optim.warmup_cosine_decay_schedule(0.0, 1e-2, 10, 40, 1e-4)
    target = nft.Banana(DIM, 1.0, 100.0)

    def run(flow, steps, gen, resume_state=None):
        return nft.train_flow(gen, nft.elbo_batch, flow, target.log_prob,
                              BATCH, max_iters=steps, check_every=10,
                              optimizer=optim.adam(sched),
                              resume_state=resume_state)

    straight = run(_port_flow(), 40, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    half = run(_port_flow(), 20, gen)
    path = str(tmp_path / "state.pt")
    ckpt.save_train_state(path, half.state, generator=gen)

    flow = _port_flow(seed=3)
    opt = optim.adam(sched)(trainable_parameters(flow))
    built_lr = opt.param_groups[0]["lr"]
    gen2 = torch.Generator().manual_seed(0)
    state = ckpt.load_train_state(path, port_train.TrainState(flow, opt, 0),
                                  generator=gen2)
    assert opt.param_groups[0]["lr"] is not built_lr
    resumed = run(flow, 20, gen2, resume_state=state)
    np.testing.assert_array_equal(
        np.concatenate([half.stats["loss"], resumed.stats["loss"]]),
        straight.stats["loss"])
    for a, b in zip(straight.flow.state_dict().values(),
                    flow.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(straight.state.opt_state.param_groups[0]["lr"],
                       opt.param_groups[0]["lr"])


# (d) a JAX train state of a scheduled Adam
def _jax_run(steps=5):
    flow = nf.realnvp(jax.random.key(0), 3, (8, 8), nlayers=2,
                      dtype=jnp.float64)
    sched = _optax_schedule((0.0, 1e-2, 3, 20, 1e-4), "f64")
    res = nf.train_flow(jax.random.key(1), nf.elbo_batch, flow,
                        nf.Banana(3, 1.0, 10.0).log_prob, 8,
                        max_iters=steps, check_every=steps,
                        optimizer=optax.adam(sched))
    return res.state, sched


def test_reads_a_jax_scheduled_train_state(tmp_path):
    """optax.adam(schedule)'s state has the schedule's own count
    (``[1][1].count``) beside Adam's: both become Adam's ``step``, so they
    must agree (a file where they differ raises); one more step on the
    same draws gives JAX's parameters and moments to rtol 1e-9."""
    state, jsched = _jax_run()
    path = str(tmp_path / "state.npz")
    jax_ckpt.save_train_state(path, state)
    paths = jax_paths((state.flow, state.opt_state, state.iteration))
    assert "[1][1].count" in paths

    def port():
        f = nft.realnvp(torch.Generator().manual_seed(5), 3, (8, 8),
                        nlayers=2, dtype=torch.float64, device="cpu")
        return f, optim.adam(optim.warmup_cosine_decay_schedule(
            0.0, 1e-2, 3, 20, 1e-4))(trainable_parameters(f))

    # a file whose two counts differ
    with np.load(path) as z:
        leaves = {k: z[k] for k in z.files}
    leaves[f"leaf_{paths.index('[1][1].count')}"] = np.asarray(4, np.int32)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **leaves)
    with pytest.raises(ValueError, match="counts differ"):
        ckpt.load_jax_checkpoint(bad, *port()[:1], paths,
                                 optimizer=port()[1])

    tflow, opt = port()
    tstate = ckpt.load_jax_checkpoint(path, tflow, paths, optimizer=opt)
    assert {float(s["step"]) for s in opt.state.values()} == {5.0}

    xs = np.random.default_rng(3).standard_normal((1, 16, 3))
    target = nf.Banana(3, 1.0, 10.0)
    flow = jax_ckpt.load_train_state(path, state).flow
    mask = trainable_mask(flow, frozen=lambda m: m is flow.base)
    grads = jax.grad(lambda f: -nf.elbo_from_samples(
        jnp.asarray(xs[0]), f, target.log_prob))(flow)
    updates, jst = optax.adam(jsched).update(apply_mask(grads, mask),
                                             state.opt_state, flow)
    jflow = optax.apply_updates(flow, updates)

    nft.train_flow(
        torch.Generator(), nft.elbo_from_samples, tflow,
        nft.Banana(3, 1.0, 10.0).log_prob, max_iters=1, resume_state=tstate,
        scan_inputs=lambda g, f, n: torch.from_numpy(xs[:n]))
    ref = _by_name(tflow, jflow)
    mu = _by_name(tflow, jst[0].mu)
    names = {id(p): n for n, p in tflow.named_parameters()}
    for p in trainable_parameters(tflow):
        n = names[id(p)]
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[n].detach().numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=n)
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(),
                                   mu[n].detach().numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=n)


# (e) a float rate changed under the graph
class _StubGraph:
    def replay(self):
        pass

    def register_generator_state(self, generator):
        pass


def _graphed_on_cpu(monkeypatch):
    """torch.cuda's streams, devices and graphs as no-ops, and the
    trainers' set-up reporting a graphed run for a CPU flow: the capture
    runs the step once (a stub records nothing) and replays do nothing."""
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    port_train._side_stream.cache_clear()
    start = port_train._start

    def graphed_start(flow, optimizer, train_base, resume_state, graph):
        flow, opt, it, params, _ = start(flow, optimizer, train_base,
                                         resume_state, False)
        return flow, opt, it, params, True

    monkeypatch.setattr(port_train, "_start", graphed_start)


@pytest.mark.parametrize("change", [None, "lr", "betas"])
def test_graphed_float_hyperparameter_change_raises(monkeypatch, change):
    """A callback that writes a new float lr (or betas) into the groups
    after the capture raises at the next chunk, naming optim.adam's
    schedule; one that leaves them alone does not, and neither does the
    schedule's tensor rate, refilled inside the step."""
    _graphed_on_cpu(monkeypatch)
    target = nft.Banana(DIM, 1.0, 100.0)

    def callback(it, stat, flow):
        for g in opt_box[0].param_groups:
            if change == "lr":
                g["lr"] = 1e-5
            elif change == "betas":
                g["betas"] = (0.5, 0.9)
            else:
                g["lr"] = g["lr"]

    opt_box = []

    def factory(params):
        opt_box.append(torch.optim.Adam(params, lr=1e-3))
        return opt_box[0]

    def train(optimizer, cb):
        return nft.train_flow(
            torch.Generator().manual_seed(0), nft.elbo_batch, _port_flow(),
            target.log_prob, 8, max_iters=12, check_every=4,
            optimizer=optimizer, callback=cb)

    if change is None:
        assert len(train(factory, callback).stats["loss"]) == 12
    else:
        with pytest.raises(RuntimeError, match=f"{change} changed.*"
                           r"optim\.adam\(warmup_cosine"):
            train(factory, callback)
    sched = optim.warmup_cosine_decay_schedule(0.0, 1e-2, 4, 12)
    assert len(train(optim.adam(sched), None).stats["loss"]) == 12
    port_train._side_stream.cache_clear()
