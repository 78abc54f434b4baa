"""Hamiltonian (leapfrog) flow on Neal's funnel.

Counterpart of `examples/demo_hamiltonian_flow.py` (reference
`example/demo_hamiltonian_flow.jl:105-171`): Funnel(2, μ=−8, σ=5),
float64 (the dynamics are chaotic — reference `:107`), 15 blocks × 3
leapfrog steps, ϵ₀=0.05, per-sample ELBO on the joint (x, ρ) space, 16
samples/iter, Adam(3e-4), grad-norm convergence at 1e-3.

    python -m normalizingflows_torch.examples.demo_hamiltonian_flow \\
        --iters 100
"""

import torch

import normalizingflows_torch as nft
from normalizingflows_torch.examples import _cli
from normalizingflows_torch.models.hamiltonian import joint_logp


def main(max_iters: int, seed: int = 123, device=None, plot=None,
         show_progress: bool = True):
    dtype = torch.float64
    _, gen = _cli.generators(seed, device)
    dim = 2

    target = nft.Funnel(dim, -8.0, 5.0)
    flow = nft.hamiltonian_flow(dim, target.score, n_blocks=15, L=3,
                                eps0=0.05, dtype=dtype, device=device)
    before_flow = _cli.untrained(flow, plot)
    lp = joint_logp(target.log_prob, dim)

    # the leapfrog steps call the funnel's analytic score, which needs no
    # autograd, so the evaluations run under no_grad
    with torch.no_grad():
        before = float(nft.elbo_batch(gen, flow, lp, 512))
    res = nft.train_flow(
        gen, nft.elbo, flow, lp, 16,
        max_iters=max_iters, optimizer=nft.optim.adam(3e-4),
        hasconverged=lambda i, s, f, st: s["gradient_norm"] < 1e-3,
        show_progress=show_progress, check_every=max(max_iters // 20, 1),
    )
    with torch.no_grad():
        after = float(nft.elbo_batch(
            torch.Generator(device=gen.device).manual_seed(7), res.flow, lp,
            512))
    print(f"joint ELBO before: {before:.4f}  after: {after:.4f}")
    if plot:  # the x block of the joint (x, ρ) samples against the funnel
        _cli.plot(plot, res.flow, before_flow, target, res.stats, device)
    return res


if __name__ == "__main__":
    a = _cli.parser(__doc__, 100).parse_args()
    main(a.iters, device=a.device, plot=a.plot)
