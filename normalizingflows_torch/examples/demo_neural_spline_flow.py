"""Neural spline flow on the HARD banana target.

Counterpart of `examples/demo_neural_spline_flow.py` (reference
`example/demo_neural_spline_flow.jl:20-53`): Banana(2, b=1, var=100),
float32, NSF defaults (10 layers, [32,32], K=10, B=30), 64 samples/iter,
Adam(1e-4). Each coupling runs the fused RQS kernels on the card (K1
forward, K2 backward).

``--affine-wrap`` trains the envelope variant instead (identity init and
Adam under a warmup-cosine schedule peaking at 5e-4, the schedule computed
inside the train step, `optim.py`): a trainable per-dim affine around the
spline stack that lifts the bare architecture's log(Z_box/2) = −2.600 ELBO
ceiling (`benchmarks/NSF_DIAGNOSE.md`).

    python -m normalizingflows_torch.examples.demo_neural_spline_flow \\
        --iters 400 --affine-wrap
"""

import torch

import normalizingflows_torch as nft
from normalizingflows_torch.examples import _cli


def main(max_iters: int, seed: int = 123, affine_wrap: bool = False,
         device=None, plot=None, show_progress: bool = True):
    dtype = torch.float32
    gen_init, gen = _cli.generators(seed, device)

    target = nft.Banana(2, 1.0, 100.0)
    flow = nft.nsf(gen_init, nft.DiagNormal.standard(2, dtype, device),
                   identity_init=affine_wrap, affine_wrap=affine_wrap,
                   device=device)
    before_flow = _cli.untrained(flow, plot)
    if affine_wrap:
        opt = nft.optim.adam(nft.optim.warmup_cosine_decay_schedule(
            0.0, 5e-4, warmup_steps=min(500, max_iters // 4 + 1),
            decay_steps=max_iters, end_value=1e-5))
    else:
        opt = nft.optim.adam(1e-4)  # reference demo optimizer

    with torch.no_grad():
        before = float(nft.elbo_batch(gen, flow, target.log_prob, 4096))
    res = nft.train_flow(
        gen, nft.elbo_batch, flow, target.log_prob, 64,
        max_iters=max_iters, optimizer=opt,
        show_progress=show_progress, check_every=max(max_iters // 20, 1),
    )
    with torch.no_grad():
        after = float(nft.elbo_batch(
            torch.Generator(device=gen.device).manual_seed(7), res.flow,
            target.log_prob, 4096))
    print(f"ELBO before: {before:.4f}  after {max_iters} iters: {after:.4f}")
    if plot:
        _cli.plot(plot, res.flow, before_flow, target, res.stats, device)
    return res


if __name__ == "__main__":
    p = _cli.parser(__doc__, 200)
    p.add_argument("--affine-wrap", action="store_true")
    a = p.parse_args()
    main(a.iters, affine_wrap=a.affine_wrap, device=a.device, plot=a.plot)
