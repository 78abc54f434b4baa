"""Training API: `train_flow` / `train_flow_mle` / `train_flow_annealed` /
`optimize`.

Counterpart of `normalizingflows/jl_tpu/train.py` (reference
`src/NormalizingFlows.jl:51-86` driving `src/optimize.jl:57-108`). One step
is: objective → loss = −objective → backward → gradient norm → optimizer
step. Steps run in chunks of ``check_every``; per-step loss and gradient
norm stay on the device and are fetched once per chunk, where the host does
the bookkeeping the reference does every iteration (stats, callback,
convergence predicate, progress line), as the JAX package does at its scan
chunk boundaries.

The JAX package runs a chunk as one jitted `lax.scan`. Here, on the card,
the step is captured once in a CUDA graph and the chunk replays it
(``graph=None``: a graph when the flow's parameters are on CUDA, the eager
loop on the CPU). Eager or graphed, it is one step body: step i of a chunk
reads its input from a static buffer at a device-side step index, writes
loss i and gradient norm i, and advances the index.

The flow is trained in place: `TrainResult.flow` is the module passed in.
`TrainState.opt_state` is the optimizer itself, which holds the moments.
"""

from __future__ import annotations

import copy
import functools
import time
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .models.distributions import TransformedDistribution
from .ops import launches
from .utils.pytree import global_norm, trainable_parameters

__all__ = ["train_flow", "train_flow_mle", "train_flow_annealed",
           "optimize", "TrainResult", "TrainState"]

OptimizerFactory = Callable[[list], torch.optim.Optimizer]

# Eager steps before the capture, on a side stream: they create Adam's
# state, the cuBLAS handles and the kernel library, which a capture cannot.
# They are steps of the run.
WARM_STEPS = 3


class TrainState(NamedTuple):
    """Resumable state (the reference returns its opt-state "for potential
    continuation of training", `src/optimize.jl:106-107`)."""

    flow: TransformedDistribution
    opt_state: torch.optim.Optimizer
    iteration: int


class TrainResult(NamedTuple):
    flow: TransformedDistribution
    stats: dict  # {"iteration", "loss", "gradient_norm", ...} 1-D arrays
    state: TrainState


def _default_optimizer(params, capturable: bool) -> torch.optim.Optimizer:
    # Reference default: Optimisers.ADAM() == Adam(lr=1e-3)
    # (`src/NormalizingFlows.jl:60`). torch's Adam with betas (0.9, 0.999)
    # and eps 1e-8 is optax.adam's update.
    return torch.optim.Adam(params, lr=1e-3, capturable=capturable)


# Optimizers a graph captures without a capturable mode: SGD keeps no step
# count, its learning rate and momentum are floats the capture bakes in, and
# its momentum buffers are made in the eager warm steps.
_STEPLESS = (torch.optim.SGD,)


def _make_capturable(opt: torch.optim.Optimizer):
    """Switch on ``capturable`` (device-side step counts) in every param
    group, and move step counts an eager run left on the host to their
    parameters' device."""
    for group in opt.param_groups:
        group["capturable"] = True
    for p, state in opt.state.items():
        step = state.get("step")
        if torch.is_tensor(step) and step.device != p.device:
            state["step"] = step.to(p.device)


def _start(flow, optimizer, train_base, resume_state, graph):
    """(flow, optimizer, first iteration, trainable parameters, graphed): a
    fresh optimizer over the trainable parameters, or the resumed run's,
    and whether the steps run from a CUDA graph."""
    if resume_state is not None:
        flow = resume_state.flow
    params = trainable_parameters(flow, train_base)
    on_cuda = bool(params) and params[0].is_cuda
    graphed = on_cuda if graph is None else bool(graph)
    if resume_state is not None:
        opt, start_iter = resume_state.opt_state, resume_state.iteration
    elif optimizer is not None:
        opt, start_iter = optimizer(params), 0
    else:
        opt, start_iter = _default_optimizer(params, graphed), 0
    if graphed:
        stepless = isinstance(opt, _STEPLESS)
        if "capturable" not in opt.defaults and not stepless:
            raise TypeError(
                f"{type(opt).__name__} has no capturable mode, which a CUDA "
                "graph of the step needs: use Adam, AdamW or SGD, or pass "
                "graph=False")
        if not on_cuda:
            raise ValueError("graph=True needs the flow's parameters on a "
                             "CUDA device; on the CPU pass graph=False or "
                             "None")
        if not stepless:
            _make_capturable(opt)
    return flow, opt, start_iter, params, graphed


# The float hyperparameters a capture of the step bakes in. A tensor lr
# (`optim.adam` with a schedule) is read by address at every replay and is
# not among them.
_BAKED_KEYS = ("lr", "betas", "eps", "weight_decay", "momentum")


def _baked(opt: torch.optim.Optimizer) -> list:
    return [{k: g[k] for k in _BAKED_KEYS
             if k in g and not torch.is_tensor(g[k])}
            for g in opt.param_groups]


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The warm steps' stream on ``device``, one for the process: cuBLAS
    keeps a workspace for each stream it has run on, for the life of the
    process."""
    return torch.cuda.Stream(device=device)


def _step_body(opt, params, loss_fn):
    """The train step on input ``inp``: (loss, gradient norm)."""

    def body(inp):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(inp)
        loss.backward()
        gnorm = global_norm([p.grad for p in params])
        opt.step()
        return loss, gnorm

    return body


class _Steps:
    """The run's steps, chunk by chunk: ``body(input)`` run eagerly, or on
    the card replayed from a CUDA graph of it.

    A chunk's inputs are a tensor (chunk, ...), copied into a static
    buffer of ``check_every`` rows (``input_dtype``, if given, is the
    buffer's dtype); None, when every step gets ``generator``; or, eagerly
    only, any sequence. Step i reads row i of the buffer at the
    device-side index, writes losses[i] and gnorms[i], and advances the
    index. The copy into the buffer does not block the host: from a
    page-locked tensor it runs on the stream, and ``copied`` (a CUDA event
    recorded after it) says when the host tensor may be written again.
    Graphed, the first ``WARM_STEPS`` steps of the run are eager on
    a side stream, then the step is captured once (capture executes
    nothing) and every later step is a replay; ``generator`` is registered
    with the graph, so each replay draws anew. The capture bakes in the
    float hyperparameters of ``opt``'s groups (`_baked`): at every later
    chunk boundary a changed one raises, where the eager loop would have
    taken it."""

    def __init__(self, body, device, check_every, graphed, generator=None,
                 input_dtype=None, opt=None):
        self.body, self.device, self.check_every = body, device, check_every
        self.graphed, self.generator = graphed, generator
        self.input_dtype = input_dtype
        self.opt, self.baked = opt, None
        self.index = torch.zeros((), dtype=torch.long, device=device)
        self.inputs = self.losses = self.gnorms = None
        self.copied = None  # recorded after the last copy into ``inputs``
        self.graph = None
        self.warm = WARM_STEPS if graphed else 0

    def _fetch(self, chunk, inputs):
        if inputs is None:
            return lambda: self.generator
        if isinstance(inputs, torch.Tensor):
            if self.inputs is None:
                self.inputs = torch.empty(
                    (self.check_every,) + tuple(inputs.shape[1:]),
                    dtype=self.input_dtype or inputs.dtype,
                    device=self.device)
            if (inputs.shape[0] != chunk
                    or inputs.shape[1:] != self.inputs.shape[1:]):
                raise ValueError(
                    f"a chunk of {chunk} steps got inputs shaped "
                    f"{tuple(inputs.shape)}; the run's first chunk had "
                    f"(chunk,) + {tuple(self.inputs.shape[1:])}")
            self.inputs[:chunk].copy_(inputs, non_blocking=True)
            if self.inputs.is_cuda:
                self.copied = torch.cuda.Event()
                self.copied.record()
            return lambda: self.inputs.index_select(
                0, self.index.view(1)).squeeze(0)
        if self.graphed:
            raise TypeError(
                "under a CUDA graph scan_inputs must return a tensor of the "
                f"chunk's inputs, got {type(inputs).__name__}; pass "
                "graph=False")
        rows = iter(inputs)
        return lambda: next(rows)

    def _step(self, fetch):
        loss, gnorm = self.body(fetch())
        if self.losses is None:
            self.losses = loss.new_empty(self.check_every)
            self.gnorms = gnorm.new_empty(self.check_every)
        at = self.index.view(1)
        self.losses.index_copy_(0, at, loss.detach().reshape(1))
        self.gnorms.index_copy_(0, at, gnorm.reshape(1))
        self.index.add_(1)

    def _capture(self, fetch):
        graph = launches.CountedGraph(torch.cuda.CUDAGraph())
        if self.generator is not None:
            register = getattr(graph.graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    "this torch cannot register a generator with a CUDA "
                    "graph, so every replay would reuse the capture's draws: "
                    "pass scan_inputs=presample_base(n) with "
                    "elbo_from_samples, or graph=False")
            register(self.generator)
        try:
            with graph.capture(torch.cuda.graph(graph.graph)):
                self._step(fetch)
        except RuntimeError as err:
            raise RuntimeError(
                f"capturing the train step in a CUDA graph failed: {err}; "
                "pass graph=False to train without a graph") from err
        self.graph = graph
        if self.opt is not None:
            self.baked = _baked(self.opt)

    def _check_baked(self):
        """Raise if a float hyperparameter of the optimizer changed since
        the capture, which replays would not see."""
        now = _baked(self.opt)
        for i, (was, is_) in enumerate(zip(self.baked, now)):
            for k in was:
                if was[k] != is_[k]:
                    raise RuntimeError(
                        f"param group {i}'s {k} changed from {was[k]!r} to "
                        f"{is_[k]!r} after the train step was captured in a "
                        "CUDA graph, which baked in the old value: a rate "
                        "that changes during a run goes inside the step, "
                        "as optim.adam(warmup_cosine_decay_schedule(...)) "
                        "puts it, or pass graph=False")

    def run(self, chunk: int, inputs):
        """``chunk`` steps on ``inputs``: (losses, gnorms), on the device."""
        if self.baked is not None:
            self._check_baked()
        fetch = self._fetch(chunk, inputs)
        self.index.zero_()
        if not self.graphed:
            for _ in range(chunk):
                self._step(fetch)
        else:
            with torch.cuda.device(self.device):
                self._run_graphed(chunk, fetch)
        return self.losses[:chunk].clone(), self.gnorms[:chunk].clone()

    def _run_graphed(self, chunk, fetch):
        eager = min(self.warm, chunk)
        if eager:
            side = _side_stream(self.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), warnings.catch_warnings():
                # Adam warns once that capturable=True runs uncaptured
                warnings.filterwarnings("ignore", message=".*capturable")
                for _ in range(eager):
                    self._step(fetch)
            torch.cuda.current_stream().wait_stream(side)
            self.warm -= eager
        if chunk > eager and self.graph is None:
            self._capture(fetch)
        for _ in range(chunk - eager):
            self.graph.replay()


class _HostChunks:
    """A loader's chunks in one host buffer of ``rows`` batches, allocated
    at the first chunk and page-locked if ``pin``. The port's loaders
    write their batches into it; another loader's ``next_batches(k)`` is
    copied in, in its own dtype."""

    def __init__(self, loader, rows: int, pin: bool):
        from .utils.data import NativeLoader, NumpyLoader

        self.loader, self.rows, self.pin = loader, rows, pin
        self.writes_out = isinstance(loader, (NativeLoader, NumpyLoader))
        self.buf = None

    def _alloc(self, shape, dtype):
        if self.buf is None:
            self.buf = torch.empty((self.rows,) + tuple(shape), dtype=dtype,
                                   pin_memory=self.pin)
        return self.buf

    def fill(self, chunk: int) -> torch.Tensor:
        """The next ``chunk`` batches, as a view of the buffer."""
        if self.writes_out:
            buf = self._alloc((self.loader.batch, self.loader.dim),
                              torch.float32)
            self.loader.next_batches(chunk, out=buf[:chunk])
            return buf[:chunk]
        batches = torch.from_numpy(np.asarray(
            self.loader.next_batches(chunk)))
        buf = self._alloc(batches.shape[1:], batches.dtype)
        if batches.shape[0] != chunk or batches.shape[1:] != buf.shape[1:]:
            raise ValueError(
                f"a chunk of {chunk} steps got batches shaped "
                f"{tuple(batches.shape)}; the run's first chunk had "
                f"(chunk,) + {tuple(buf.shape[1:])}")
        buf[:chunk].copy_(batches)
        return buf[:chunk]


def _host(t: torch.Tensor) -> np.ndarray:
    """A chunk's per-step values on the host; bfloat16 (which numpy lacks)
    widened exactly to float32."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _drive_chunks(run_chunk, flow, opt, start_iter, max_iters, check_every,
                  callback, hasconverged, show_progress, label) -> TrainResult:
    """Host-side chunk driver: ``run_chunk(chunk)`` runs ``chunk`` steps and
    returns their losses and gradient norms as device tensors; then the
    chunk-boundary bookkeeping of the reference (`src/optimize.jl:85-105`)."""
    all_loss: list[np.ndarray] = []
    all_gnorm: list[np.ndarray] = []
    extra: dict[str, list] = {}
    it = start_iter
    converged = False
    t0 = time.perf_counter()

    while it < start_iter + max_iters and not converged:
        chunk = min(check_every, start_iter + max_iters - it)
        losses, gnorms = run_chunk(chunk)
        losses = _host(losses)   # one device→host fetch per chunk
        gnorms = _host(gnorms)
        all_loss.append(losses)
        all_gnorm.append(gnorms)
        it += chunk

        stat = {"iteration": it, "loss": float(losses[-1]),
                "gradient_norm": float(gnorms[-1])}
        if callback is not None:
            merged = callback(it, stat, flow)
            if merged:
                stat.update(merged)
                for k, v in merged.items():
                    extra.setdefault(k, []).append(v)
        if hasconverged is not None:
            converged = bool(hasconverged(it, stat, flow, opt))
        if show_progress:
            rate = (it - start_iter) / max(time.perf_counter() - t0, 1e-9)
            print(f"[{label}] iter {it:>7d}  loss {stat['loss']:+.6f}  "
                  f"|g| {stat['gradient_norm']:.3e}  ({rate:.1f} it/s)",
                  flush=True)

    loss_arr = np.concatenate(all_loss) if all_loss else np.zeros((0,))
    gnorm_arr = np.concatenate(all_gnorm) if all_gnorm else np.zeros((0,))
    stats = {
        "iteration": np.arange(start_iter + 1, start_iter + 1 + len(loss_arr)),
        "loss": loss_arr,
        "gradient_norm": gnorm_arr,
    }
    for k, v in extra.items():
        stats[k] = np.asarray(v)
    return TrainResult(flow, stats, TrainState(flow, opt, it))


def _objective_steps(generator, objective, flow, args, optimizer, train_base,
                     resume_state, scan_inputs, graph, check_every):
    """`train_flow`'s set-up: (flow, optimizer, first iteration,
    run_chunk)."""
    flow, opt, start_iter, params, graphed = _start(
        flow, optimizer, train_base, resume_state, graph)
    steps = _Steps(
        _step_body(opt, params, lambda inp: -objective(inp, flow, *args)),
        params[0].device, check_every, graphed,
        generator=generator if scan_inputs is None else None, opt=opt)

    def run_chunk(chunk):
        inputs = (None if scan_inputs is None
                  else scan_inputs(generator, flow, chunk))
        return steps.run(chunk, inputs)

    return flow, opt, start_iter, run_chunk


def train_flow(
    generator: torch.Generator,
    objective: Callable[..., torch.Tensor],
    flow: TransformedDistribution,
    *args: Any,
    max_iters: int = 1000,
    optimizer: OptimizerFactory | None = None,
    train_base: bool = False,
    callback: Callable[[int, dict, TransformedDistribution], dict | None]
    | None = None,
    hasconverged: Callable[[int, dict, TransformedDistribution, Any], bool]
    | None = None,
    show_progress: bool = False,
    check_every: int = 100,
    resume_state: TrainState | None = None,
    scan_inputs: Callable[[torch.Generator, TransformedDistribution, int],
                          Any] | None = None,
    graph: bool | None = None,
) -> TrainResult:
    """Train ``flow`` by maximising ``objective(input, flow, *args)``.

    The loss is the negated objective; per-step stats are ``(iteration,
    loss, gradient_norm)``; ``callback(i, stats, flow)`` may return a dict
    merged into the stats and ``hasconverged(i, stats, flow, opt_state)``
    stops the loop. Both run every ``check_every`` steps (chunk boundary).
    A callback may change parameters in place (``p.copy_(...)``) but must
    not rebind them (``p.data = ...``): a graph reads them at their
    addresses.

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer`` (default
    Adam(lr=1e-3)). ``train_base=False`` freezes ``flow.base``.
    ``scan_inputs(generator, flow, chunk)`` gives the chunk's per-step
    inputs: a tensor (chunk, ...), made outside the graph; eagerly, any
    sequence. By default every step gets ``generator`` and draws inside
    the step. Pass `objectives.presample_base(n)` with the
    `elbo_from_samples` objective to draw a whole chunk's base samples in
    one call.

    ``graph``: None runs the steps from a CUDA graph when the flow's
    parameters are on CUDA and eagerly on the CPU; True insists on the
    graph (and raises on the CPU); False runs eagerly. The graph is the
    counterpart of the JAX package's jitted `lax.scan`: the first
    `WARM_STEPS` steps run eagerly, the step is captured once, and every
    later step is a replay. It needs an optimizer with a capturable mode:
    the default is then Adam(lr=1e-3, capturable=True), and a caller's
    Adam or AdamW gets ``capturable=True`` switched on in its param groups
    before the first step; another optimizer raises. A capture that fails
    raises; nothing falls back to the eager loop.
    """
    flow, opt, start_iter, run_chunk = _objective_steps(
        generator, objective, flow, args, optimizer, train_base,
        resume_state, scan_inputs, graph, check_every)
    return _drive_chunks(run_chunk, flow, opt, start_iter, max_iters,
                         check_every, callback, hasconverged, show_progress,
                         "train_flow")


def train_flow_mle(
    flow: TransformedDistribution,
    loader,
    max_iters: int = 1000,
    optimizer: OptimizerFactory | None = None,
    train_base: bool = False,
    check_every: int = 100,
    show_progress: bool = False,
    callback: Callable[[int, dict, TransformedDistribution], dict | None]
    | None = None,
    hasconverged: Callable[[int, dict, TransformedDistribution, Any], bool]
    | None = None,
    resume_state: TrainState | None = None,
    graph: bool | None = None,
) -> TrainResult:
    """Forward-KL (maximum-likelihood) training from a data loader.

    ``loader`` is any object with ``next_batches(k) -> (k, batch, dim)``
    (`utils.data.make_loader`). Per chunk of ``check_every`` steps the
    chunk's batches are fetched once into one host buffer, page-locked
    when the flow is on the card (the port's `NativeLoader` and
    `NumpyLoader` write into it, ``next_batches(k, out=)``; another
    loader's chunk is copied in), and copied, in one host→device copy that
    does not block, into a static buffer in the flow's dtype; the next
    chunk waits for that copy before it refills the host buffer. Each step
    maximises `objectives.loglikelihood` of its batch, the density path
    (inverse with log-det). `_drive_chunks`, stats, callback, convergence
    check and ``graph`` are `train_flow`'s. ``train_base=False`` freezes
    ``flow.base``.
    """
    from .objectives import loglikelihood

    flow, opt, start_iter, params, graphed = _start(
        flow, optimizer, train_base, resume_state, graph)
    steps = _Steps(
        _step_body(opt, params, lambda batch: -loglikelihood(flow, batch)),
        params[0].device, check_every, graphed, input_dtype=params[0].dtype,
        opt=opt)
    host = _HostChunks(loader, check_every, pin=params[0].is_cuda)

    def run_chunk(chunk):
        if steps.copied is not None:
            steps.copied.synchronize()  # the last chunk left the host buffer
        return steps.run(chunk, host.fill(chunk))

    return _drive_chunks(run_chunk, flow, opt, start_iter, max_iters,
                         check_every, callback, hasconverged, show_progress,
                         "train_flow_mle")


def train_flow_annealed(
    generator: torch.Generator,
    objective: Callable[..., torch.Tensor],
    flow: TransformedDistribution,
    logp: Callable[[torch.Tensor], torch.Tensor],
    n_samples: int,
    *,
    n_betas: int = 10,
    iters_per_beta: int = 500,
    final_iters: int | None = None,
    ref_logp: Callable[[torch.Tensor], torch.Tensor] | None = None,
    optimizer: OptimizerFactory | None = None,
    train_base: bool = False,
    callback: Callable[[int, dict, TransformedDistribution], dict | None]
    | None = None,
    hasconverged: Callable[[int, dict, TransformedDistribution, Any], bool]
    | None = None,
    show_progress: bool = False,
    check_every: int = 100,
    resume_state: TrainState | None = None,
    scan_inputs: Callable[[torch.Generator, TransformedDistribution, int],
                          Any] | None = None,
    graph: bool | None = None,
) -> TrainResult:
    """Annealed (tempered-path) reverse-KL training.

    Trains against ``log p_β = (1−β)·log q_ref + β·log p`` for β ramping
    linearly over ``n_betas`` segments of ``iters_per_beta`` iterations
    (β = 1/n_betas, ..., 1), the last of which runs ``final_iters``
    (default ``iters_per_beta``) at β=1. ``q_ref`` defaults to a frozen
    copy of ``flow.base`` as passed in (before any step, and not
    ``resume_state``'s), so the β=0 problem is the identity map and the
    path stays put when ``train_base=True`` moves the base. ``objective``
    is called as ``objective(input, flow, logp_β, n_samples)``
    (`objectives.tempered`).
    The other keywords are `train_flow`'s; each segment is a `train_flow`
    run resumed from the last. β is one 0-dim tensor on the flow's device,
    filled in place per segment, so the optimizer and one captured step
    carry across segments. ``stats["beta"]`` gives each step's β.

    The JAX package's ``unroll=`` has no counterpart: a graph already
    lays every step's kernels out.
    """
    from .objectives import tempered

    # JAX binds flow.base.log_prob on an immutable pytree: the argument's
    # base as it was. A deep copy keeps it so, on the base's device.
    ref = (ref_logp if ref_logp is not None else
           copy.deepcopy(flow.base).requires_grad_(False).log_prob)
    if resume_state is not None:
        flow = resume_state.flow
    like = next(flow.parameters())
    beta = torch.zeros((), dtype=like.dtype, device=like.device)
    flow, opt, it, run_chunk = _objective_steps(
        generator, tempered(objective, ref), flow, (logp, n_samples, beta),
        optimizer, train_base, resume_state, scan_inputs, graph, check_every)

    all_stats: list[dict] = []
    state = None
    for j in range(1, n_betas + 1):
        iters = (final_iters if final_iters is not None and j == n_betas
                 else iters_per_beta)
        beta.fill_(j / n_betas)
        res = _drive_chunks(run_chunk, flow, opt, it, iters, check_every,
                            callback, hasconverged, show_progress,
                            "train_flow")
        it, state = res.state.iteration, res.state
        stats = dict(res.stats)
        stats["beta"] = np.full((len(stats["loss"]),), j / n_betas)
        all_stats.append(stats)

    merged = {k: np.concatenate([s[k] for s in all_stats])
              for k in all_stats[0]}
    return TrainResult(flow, merged, state)


def optimize(
    generator: torch.Generator,
    loss: Callable[..., torch.Tensor],
    params: torch.nn.Module,
    *args: Any,
    max_iters: int = 10_000,
    optimizer: OptimizerFactory | None = None,
    **kwargs: Any,
) -> TrainResult:
    """Minimise ``loss(input, params, *args)`` over a module's parameters
    (all of them) — the standalone analogue of `optimize` at
    `src/optimize.jl:57-108`. Takes the same kwargs as `train_flow`,
    ``graph`` included."""
    return train_flow(
        generator, lambda g, p, *a: -loss(g, p, *a), params, *args,
        max_iters=max_iters, optimizer=optimizer, train_base=True, **kwargs)
