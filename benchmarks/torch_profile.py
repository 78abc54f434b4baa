"""Where the time goes in the PyTorch port's training steps, on one GPU.

    python benchmarks/torch_profile.py [--out FILE]

Prints one JSON object (and writes it to ``--out`` if given):

* ``train``: for the NSF configurations in float32, reverse-KL ELBO
  training (`train_flow`: demo d=2, [32,32]x10, batch 64; wide d=64,
  [128,128]x10, batch 4096) and maximum-likelihood training
  (`train_flow_mle` on 65,536 draws of Banana(d, 1, 10): mle_demo, batch
  256; mle_wide, batch 4096), and RealNVP ELBO training on Banana(d, 1,
  100): the demo (d=2, [16,16]x3, batch 16, Adam(5e-4)) through the fused
  coupling kernels (rnvp_fused) and the unfused module path
  (rnvp_unfused), the reference default ([32,32]x10, batch 256, fused;
  rnvp_ref) and the wide unfused shape (d=128, [256,256]x10, batch 4096,
  Adam(1e-3)) with and without remat (rnvp_wide, rnvp_wide_noremat); the
  demo again through `train_realnvp_fused`, many steps a launch of the
  whole-run kernel K6 (rnvp_whole_run; each call draws its steps' base
  samples and starts Adam afresh), and its eager fused step captured in a
  CUDA graph and replayed (rnvp_graph, `capture_train_step`):
  steps/s by host clock (3 runs, taken before any profiler run, which
  slows later launches) and the peak device memory of those runs beside
  what was allocated before them (this and earlier cells' flows and
  optimizer states), then a
  `torch.profiler` trace of a few steps: kernels per step, device-busy time
  (union of kernel intervals), the device's idle share of the wall time,
  and device time by category (rqs, coupling, gemm, optimizer, reduce,
  elementwise) and by kernel.

The times of K1–K6 against their plain versions are `chip_smoke.py`'s
(phases 3, 12, 18 and 20). Needs a CUDA device; builds the kernels from
``normalizingflows_torch/csrc``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import normalizingflows_torch as nft  # noqa: E402

B = 30.0
MLE_ROWS = 65536
RNVP_WIDE = dict(q0=128, hdims=(256, 256), nlayers=10)
# name, nsf (realnvp for rnvp_) kwargs, target dim, batch, Adam lr, profiled
# steps; the mle_ cells train by maximum likelihood on draws of
# Banana(d, 1, 10)
CELLS = (("demo", dict(q0=2, hdims=(32, 32)), 2, 64, 5e-4, 20),
         ("wide", dict(q0=64, hdims=(128, 128)), 64, 4096, 1e-3, 10),
         ("mle_demo", dict(q0=2, hdims=(32, 32)), 2, 256, 1e-3, 20),
         ("mle_wide", dict(q0=64, hdims=(128, 128)), 64, 4096, 1e-3, 10),
         ("rnvp_fused", dict(q0=2, hdims=(16, 16), nlayers=3, fused=True), 2,
          16, 5e-4, 50),
         ("rnvp_unfused", dict(q0=2, hdims=(16, 16), nlayers=3), 2, 16, 5e-4,
          50),
         ("rnvp_ref", dict(q0=2, hdims=(32, 32), nlayers=10, fused=True), 2,
          256, 5e-4, 50),
         ("rnvp_wide", dict(RNVP_WIDE, remat=True), 128, 4096, 1e-3, 5),
         ("rnvp_wide_noremat", RNVP_WIDE, 128, 4096, 1e-3, 5),
         ("rnvp_whole_run", dict(q0=2, hdims=(16, 16), nlayers=3,
                                 fused=True), 2, 16, 5e-4, 50),
         ("rnvp_graph", dict(q0=2, hdims=(16, 16), nlayers=3, fused=True), 2,
          16, 5e-4, 50))


def capture_train_step(flow, target, batch: int, lr: float, side=None):
    """One eager ELBO train step of a fused RealNVP flow (base draws from
    the default CUDA generator, which a graph replays; forward, ELBO,
    backward, Adam(capturable=True) on the stack's weights) captured in a
    CUDA graph after 3 steps on the side stream ``side`` (a new one if
    None): (graph, its loss). `chip_smoke.py` phase 21 times it too."""
    fb = flow.bijector.bijectors[0]
    opt = torch.optim.Adam(fb.parameters(), lr=lr, capturable=True)

    def step():
        xs = flow.base.sample(None, (batch,))
        loss = -nft.elbo_from_samples(xs, flow, target.log_prob)
        loss.backward()
        opt.step()
        return loss.detach()

    side = side or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            flow.zero_grad(set_to_none=True)
            step()
    torch.cuda.current_stream().wait_stream(side)
    flow.zero_grad(set_to_none=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loss = step()
    return graph, loss


def _kernel_events(prof):
    """Device kernels only: GPU-side ranges of user annotations (such as
    ``Optimizer.step#Adam.step``) also carry device_type CUDA."""
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.name]


def _category(name: str) -> str:
    low = name.lower()
    if "rqs_" in name:
        return "rqs"
    if "coupling_" in name or "realnvp_train" in name:
        return "coupling"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    if "multi_tensor" in low or "foreach" in low or "adam" in low:
        return "optimizer"
    if "reduce" in low:
        return "reduce"
    return "elementwise/other"


def _busy_us(events) -> float:
    """Length of the union of the kernels' time intervals."""
    busy, start, end = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if end is None or s > end:
            if end is not None:
                busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return busy + (end - start if end is not None else 0.0)


def _breakdown(prof, steps: int, wall_s: float) -> dict:
    ev = _kernel_events(prof)
    cats: dict[str, list] = {}
    names: dict[str, list] = {}
    for e in ev:
        for table, key in ((cats, _category(e.name)), (names, e.name[:90])):
            row = table.setdefault(key, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us()
    busy = _busy_us(ev)
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "wall_ms_per_step": wall_s / steps * 1e3,
        "kernels_per_step": len(ev) / steps,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_idle_share": 1.0 - busy / 1e6 / wall_s,
        "ms_per_step_by_category": {
            k: round(v[1] / steps / 1e3, 4) for k, v in cats.items()},
        "kernels_per_step_by_category": {
            k: v[0] / steps for k, v in cats.items()},
        "top_kernels": [(k, v[0] / steps, round(v[1] / steps / 1e3, 4))
                        for k, v in top],
    }


def _cell(name, cfg, dim, batch, lr, gen):
    if name.startswith("rnvp_"):
        flow = nft.realnvp(torch.Generator().manual_seed(0), **cfg)
    else:
        flow = nft.nsf(torch.Generator().manual_seed(0), K=10, B=B,
                       nlayers=10, identity_init=True, **cfg)
    kw = dict(optimizer=lambda p: torch.optim.Adam(p, lr=lr),
              check_every=100)
    if name.startswith("mle_"):
        data = nft.Banana(dim, 1.0, 10.0).sample(gen, (MLE_ROWS,))
        loader = nft.utils.data.make_loader(data.cpu().numpy(), batch)

        def run(state, steps):
            return nft.train_flow_mle(flow, loader, max_iters=steps,
                                      resume_state=state, **kw).state
        return run, run(None, 10)  # warm: cuBLAS handles, allocator

    target = nft.Banana(dim, 1.0, 100.0)
    if name == "rnvp_whole_run":
        def run(state, steps):
            return nft.train_realnvp_fused(gen, flow, target, batch,
                                           max_iters=steps,
                                           learning_rate=lr).state
        return run, run(None, 10)
    if name == "rnvp_graph":
        graph, _ = capture_train_step(flow, target, batch, lr)

        def run(state, steps):
            for _ in range(steps):
                graph.replay()
            return state
        return run, run(None, 10)

    def run(state, steps):
        return nft.train_flow(gen, nft.elbo_batch, flow, target.log_prob,
                              batch, max_iters=steps, resume_state=state,
                              **kw).state

    return run, run(None, 10)  # warm: cuBLAS handles, allocator


def train_cells(gen) -> dict:
    out = {}
    runs = {}
    for name, cfg, dim, batch, lr, steps in CELLS:
        run, state = _cell(name, cfg, dim, batch, lr, gen)
        rates = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = run(state, 10 * steps)
            torch.cuda.synchronize()
            rates.append(10 * steps / (time.perf_counter() - t0))
        runs[name] = (run, state, steps)
        out[name] = {"steps_per_s_3_runs": rates,
                     "steps_per_s_median": statistics.median(rates),
                     "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                     "held_before_mib": held / 2**20}
    for name, (run, state, steps) in runs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(state, steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[name].update(_breakdown(prof, steps, wall))
        out[name]["profiled_steps"] = steps
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": torch.cuda.get_device_name(0),
              "train": train_cells(gen)}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
