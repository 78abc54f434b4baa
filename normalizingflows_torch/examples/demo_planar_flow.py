"""Planar flow on the (easy) banana target.

Counterpart of `examples/demo_planar_flow.py` (reference
`example/demo_planar_flow.jl:16-48`): Banana(2, b=1, var=10), float64,
10 planar layers, 32 samples/iter, Adam(1e-2), batched ELBO (pass --iters
10000 for the parity row's length).

    python -m normalizingflows_torch.examples.demo_planar_flow --iters 200
"""

import torch

import normalizingflows_torch as nft
from normalizingflows_torch.examples import _cli


def main(max_iters: int, seed: int = 123, device=None, plot=None,
         show_progress: bool = True):
    dtype = torch.float64
    gen_init, gen = _cli.generators(seed, device)

    target = nft.Banana(2, 1.0, 10.0)
    flow = nft.planarflow(gen_init, nft.DiagNormal.standard(2, dtype, device),
                          nlayers=10, dtype=dtype, device=device)
    before_flow = _cli.untrained(flow, plot)

    with torch.no_grad():
        before = float(nft.elbo_batch(gen, flow, target.log_prob, 1024))
    res = nft.train_flow(
        gen, nft.elbo_batch, flow, target.log_prob, 32,
        max_iters=max_iters, optimizer=nft.optim.adam(1e-2),
        show_progress=show_progress, check_every=max(max_iters // 20, 1),
    )
    with torch.no_grad():
        after = float(nft.elbo_batch(
            torch.Generator(device=gen.device).manual_seed(7), res.flow,
            target.log_prob, 1024))
    print(f"ELBO before: {before:.4f}  after {max_iters} iters: {after:.4f}")
    if plot:
        _cli.plot(plot, res.flow, before_flow, target, res.stats, device)
    return res


if __name__ == "__main__":
    a = _cli.parser(__doc__, 200).parse_args()
    main(a.iters, device=a.device, plot=a.plot)
