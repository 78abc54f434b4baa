"""Glow-style flow on the Cross target.

Counterpart of `examples/demo_glow.py` (no reference demo; the reference
ships the Cross target, `example/targets/cross.jl:30-38`): 6 Glow blocks
(ActNorm, learned PLU mixing, affine coupling with [32,32] conditioners),
ActNorms initialized from 1,024 base draws, 64 samples/iter, Adam(2e-3),
batched ELBO.

    python -m normalizingflows_torch.examples.demo_glow --iters 200
"""

import torch

import normalizingflows_torch as nft
from normalizingflows_torch.examples import _cli


def main(max_iters: int, seed: int = 123, device=None, plot=None,
         show_progress: bool = True):
    gen_init, gen = _cli.generators(seed, device)
    target = nft.Cross(device=device)

    flow = nft.glow(gen_init, 2, (32, 32), nlayers=6, device=device)
    # Glow data-dependent init: normalize each ActNorm over a base batch
    with torch.no_grad():
        flow = nft.glow_init_actnorms(flow, flow.base.sample(gen, (1024,)))
    before_flow = _cli.untrained(flow, plot)

    with torch.no_grad():
        before = float(nft.elbo_batch(gen, flow, target.log_prob, 1024))
    res = nft.train_flow(
        gen, nft.elbo_batch, flow, target.log_prob, 64,
        max_iters=max_iters, optimizer=nft.optim.adam(2e-3),
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
