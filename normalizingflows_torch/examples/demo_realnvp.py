"""RealNVP on the HARD banana target.

Counterpart of `examples/demo_realnvp.py` (reference
`example/demo_RealNVP.jl:20-61`): Banana(2, b=1, var=100), float32, 3
RealNVP layers with [16,16] conditioners (the unfused module path), 16
samples/iter, Adam(5e-4), batched ELBO; ``--stl`` trains the
sticking-the-landing estimator.

    python -m normalizingflows_torch.examples.demo_realnvp --iters 500
"""

import torch

import normalizingflows_torch as nft
from normalizingflows_torch.examples import _cli


def main(max_iters: int, seed: int = 123, use_stl: bool = False,
         device=None, plot=None, show_progress: bool = True):
    dtype = torch.float32
    gen_init, gen = _cli.generators(seed, device)

    target = nft.Banana(2, 1.0, 100.0)
    flow = nft.realnvp(gen_init, nft.DiagNormal.standard(2, dtype, device),
                       (16, 16), nlayers=3, dtype=dtype, device=device)
    before_flow = _cli.untrained(flow, plot)

    objective = nft.elbo_stl if use_stl else nft.elbo_batch
    with torch.no_grad():
        before = float(nft.elbo_batch(gen, flow, target.log_prob, 4096))
    res = nft.train_flow(
        gen, objective, flow, target.log_prob, 16,
        max_iters=max_iters, optimizer=nft.optim.adam(5e-4),
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
    p = _cli.parser(__doc__, 500)
    p.add_argument("--stl", action="store_true")
    a = p.parse_args()
    main(a.iters, use_stl=a.stl, device=a.device, plot=a.plot)
