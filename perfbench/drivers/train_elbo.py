"""Reverse-KL ELBO training through the port's `train_flow`, the step
captured in a CUDA graph and replayed (its default on the card), Adam on
the flow's weights, base draws made a chunk at a time by the traffic's
feed (`presample_base`) from the run's generator.

Traffic parameters: ``batch`` (base draws a step), ``check_every`` (steps
a chunk: one host fetch of the losses, where the window's clock reads),
``objective`` and ``feed`` (names in `normalizingflows_torch.objectives`).

One `train_flow` call, on one flow and one optimizer built from the seed,
makes the whole run. Its first ``WARM_CHUNKS`` chunks are set-up: the
first has the eager warm steps, the capture and the replays after it; the
second refills the chunk's buffer and replays only. The window opens at
the boundary after them and closes at the first boundary past
``seconds``, after a device sync.

`correct`: while set-up runs, a probe (`_Probe`) keeps the flow's weights
and Adam's moments after the steps around those checked
(`checked_steps`): the first ``FIRST`` (three eager, then replays reading
rows 3 to 5 of the first chunk's buffer), and in the second chunk the
steps on its first row and on one row drawn from the seed. The float64
reference takes each checked step from the state the program held before
it, on the same draws, made again from the generator's state at the
chunk's start. Compared (`checks`): each step's loss; the gradient as
Adam took it, worked out from its moments; each leaf's change against the
reference's Adam step added to the program's weights and rounded to their
dtype (late in a run a leaf whose second moment is large steps by less
than an ulp of its weights); the last two by the worst leaf. Following the program's
own state, not a trajectory of the reference's own: Adam moves every
weight by about its rate whatever the gradient's size, so a weight whose
gradient is zero to rounding moves one way in float32 and the other in
float64, and from the third step on two trajectories part by more than a
control does (PERF.md).
"""

from __future__ import annotations

import random
import time

import torch

from .. import checks, systems, weights
from ..harness import TRACE_S, Outcome
from ..reference import vi
from ..tracing import Tracer

FIRST = 6
WARM_CHUNKS = 2
BIG = 10 ** 15


def checked_steps(run) -> list:
    """The steps (counted from 1) that the reference checks."""
    every = run.cell.traffic["check_every"]
    row = random.Random(run.seed).randrange(1, every)
    return sorted({*range(1, FIRST + 1), every + 1, every + row + 1})


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class _Probe:
    """The flow's weights and Adam's moments in the canonical layout
    after chosen steps of the run, as the run makes them: an eager step is
    seen by the optimizer's step hooks (the outermost call's end, where a
    step method wraps another), a replay of the captured step by wrapping
    `torch.cuda.CUDAGraph.replay`; the capture, which runs nothing, is not
    a step. Each copy is queued on the stream the step ran on. In place
    from the optimizer's making to `close`."""

    def __init__(self, fam, flow, wanted):
        self.fam, self.flow, self.wanted = fam, flow, set(wanted)
        self.steps, self.snaps, self.depth = 0, {}, 0
        self.opt, self.hooks, self.replay = None, [], None

    def attach(self, opt):
        self.opt = opt
        self.hooks = [opt.register_step_pre_hook(self._enter),
                      opt.register_step_post_hook(self._eager)]
        if torch.cuda.is_available():
            self.replay = torch.cuda.CUDAGraph.replay
            probe = self

            def replay(graph):
                probe.replay(graph)
                probe._stepped()

            torch.cuda.CUDAGraph.replay = replay

    def _enter(self, opt, args, kwargs):
        self.depth += 1

    def _eager(self, opt, args, kwargs):
        self.depth -= 1
        if self.depth == 0 and not _capturing():
            self._stepped()

    def _stepped(self):
        self.steps += 1
        if self.steps not in self.wanted:
            return
        state = self.opt.state

        def keep(of):
            return self.fam.canonical(self.flow,
                                      lambda p: of(p).detach().clone())

        self.snaps[self.steps] = {
            "p": keep(lambda p: p),
            "m": keep(lambda p: state[p]["exp_avg"]),
            "v": keep(lambda p: state[p]["exp_avg_sq"])}

    def close(self):
        for hook in self.hooks:
            hook.remove()
        self.hooks = []
        if self.replay is not None:
            torch.cuda.CUDAGraph.replay = self.replay
            self.replay = None


def _optimizer(cfg, probe):
    opt = cfg["optimizer"]

    def make(params):
        adam = torch.optim.Adam(params, lr=opt["lr"],
                                betas=tuple(opt["betas"]), eps=opt["eps"])
        probe.attach(adam)
        return adam

    return make


def _program(run):
    cfg, traffic = run.cell.config, run.cell.traffic
    every = traffic["check_every"]
    nft, fam = systems.program(), systems.family(cfg)
    run.mark("the port imported")
    ref, _ = vi.modules(cfg)
    gen = weights.generator(run.seed, run.device)
    w = weights.draw(ref.leaves(cfg), gen, run.device)
    flow = fam.build(cfg, w, run.device)
    del w
    run.mark("the flow built")
    logp = systems.target(cfg).log_prob
    objective = getattr(nft.objectives, traffic["objective"])
    feed_of = getattr(nft.objectives, traffic["feed"])(traffic["batch"])
    steps = checked_steps(run)
    probe = _Probe(fam, flow, {k for s in steps for k in (s - 1, s)} - {0})
    states = []

    def feed(g, fl, chunk):
        if len(states) < WARM_CHUNKS:
            states.append(g.get_state())
        return feed_of(g, fl, chunk)

    launches = nft.ops.launches
    clock = {}
    tracer = Tracer(run.sync) if run.trace else None

    def boundary(it, stat, fl):
        run.sync()
        if it < WARM_CHUNKS * every:
            run.mark(f"set-up: {it} steps")
            return
        if "start" not in clock:
            probe.close()
            if tracer is not None:
                clock["counts0"] = launches.counts()
                tracer.start()
                clock["trace_it0"] = it
            clock.update(start=time.perf_counter(), it0=it)
            run.mark("the window opens")
        now = time.perf_counter()
        clock.update(now=now, it=it)
        done = now - clock["start"] >= run.seconds
        if tracer is not None and tracer.prof is not None and (
                now - tracer.t0 >= TRACE_S or done):
            counts = {k: v - clock["counts0"][k]
                      for k, v in launches.counts().items()
                      if v != clock["counts0"][k]}
            clock["trace"] = tracer.stop(it - clock["trace_it0"], counts)

    def over(it, stat, fl, opt):
        return "start" in clock and \
            clock["now"] - clock["start"] >= run.seconds

    try:
        res = nft.train_flow(gen, objective, flow, logp, max_iters=BIG,
                             check_every=every,
                             optimizer=_optimizer(cfg, probe),
                             scan_inputs=feed, callback=boundary,
                             hasconverged=over)
    finally:
        probe.close()
    if probe.steps != WARM_CHUNKS * every:
        raise RuntimeError(
            f"the probe saw {probe.steps} steps in set-up's "
            f"{WARM_CHUNKS * every}: the program no longer makes a step an "
            "optimizer step or a graph replay")
    n_steps = clock["it"] - clock["it0"]
    window = clock["now"] - clock["start"]
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    metrics = {"train_draws_per_s": n_steps * traffic["batch"] / window,
               "setup_s": clock["start"] - run.t_process}
    run.log(f"window: {n_steps} steps in {window!r} s; set-up "
            f"{metrics['setup_s']!r} s; checked steps {steps}")
    losses = res.stats["loss"]
    program = {"steps": steps, "snaps": probe.snaps,
               "losses": {k: float(losses[k - 1]) for k in steps}}
    return metrics, n_steps, peak, clock.get("trace"), program, states


def reference_draws(run, states, steps) -> dict:
    """{step: its base draws}, made again from the generator's state at
    each chunk's start: N(0, I) of (check_every, batch, dim) a chunk, as
    the feed drew them; row i of a chunk is its step i + 1."""
    cfg, traffic = run.cell.config, run.cell.traffic
    every, batch = traffic["check_every"], traffic["batch"]
    gen = weights.generator(run.seed, run.device)
    out = {}
    for c, st in enumerate(states):
        rows = [k - 1 - c * every for k in steps
                if c * every < k <= (c + 1) * every]
        if not rows:
            continue
        gen.set_state(st)
        chunk = torch.randn((every, batch, cfg["dim"]), generator=gen,
                            device=run.device)
        for r in rows:
            out[c * every + r + 1] = chunk[r].clone()
        del chunk
    return out


def readings(program: dict, run, draws: dict, w0: dict) -> dict:
    """The numbers compared for a program's (or the control's) run: its
    losses, and its weights and Adam moments after each step around the
    checked ones (``snaps[k]``: ``p``, ``m``, ``v`` after step k)."""
    cfg = run.cell.config
    b1 = cfg["optimizer"]["betas"][0]
    zero = {k: torch.zeros_like(v) for k, v in w0.items()}
    out = dict.fromkeys(("loss", "grad", "grad_median", "update",
                         "update_median"), 0.0)
    for t in program["steps"]:
        before = ({"p": w0, "m": zero, "v": zero} if t == 1
                  else program["snaps"][t - 1])
        after = program["snaps"][t]
        p = {k: v.double() for k, v in before["p"].items()}
        ref_loss, g, delta, _, _ = vi.adam_step(
            p, before["m"], before["v"], t, draws[t], cfg, "float64")
        got = {k: (after["m"][k].double() - b1 * before["m"][k].double())
               / (1 - b1) for k in g}
        moved = {k: after["p"][k].double() - p[k] for k in p}
        # the reference's step as weights stored in the configuration's
        # dtype hold it: a step under half an ulp of its weight is none
        held = {k: (p[k] + delta[k]).to(before["p"][k].dtype).double()
                - p[k] for k in p}
        keep = checks.moving_leaves(g)
        gaps = {
            "loss": abs(program["losses"][t] - ref_loss) / abs(ref_loss),
            "grad": checks.leaf_gap(got, g),
            "grad_median": checks.leaf_gap(got, g, median=True),
            "update": checks.leaf_gap(moved, held, keep),
            "update_median": checks.leaf_gap(moved, held, keep,
                                             median=True)}
        for k, v in gaps.items():
            out[k] = max(out[k], v)
    return out


def control(run, draws_of_every_step, w0: dict, steps) -> dict:
    """The reference in TF32 put in the program's place: its own Adam
    trajectory from the seed over every step up to the last checked one,
    kept as a program run is."""
    keep = {k for s in steps for k in (s - 1, s)} - {0}
    ctl = vi.train(w0, draws_of_every_step, run.cell.config, "tf32",
                   keep=keep)
    return {"steps": steps, "losses": {k: ctl["losses"][k - 1]
                                       for k in steps},
            "snaps": {k: {"p": ctl["p"][k], "m": ctl["m"][k],
                          "v": ctl["v"][k]} for k in keep}}


def seed_weights(run) -> dict:
    cfg = run.cell.config
    ref, _ = vi.modules(cfg)
    return weights.draw(ref.leaves(cfg),
                        weights.generator(run.seed, run.device), run.device)


def run(run) -> Outcome:
    metrics, n_steps, peak, trace, program, states = _program(run)

    def judge():
        return readings(program, run,
                        reference_draws(run, states, program["steps"]),
                        seed_weights(run))

    return Outcome(metrics, n_steps, peak, trace, judge)
