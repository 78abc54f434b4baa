"""MAF trained by maximum likelihood from a data file.

Counterpart of `examples/demo_maf_mle.py`, the forward-KL pipeline the
reference leaves as a TODO (`src/objectives/loglikelihood.jl:35-43`), end
to end: 65,536 exact draws of Banana(2, 1, 10) → a raw float32 file →
the native prefetching loader (`native/dataloader.cc`, `utils/data.py`) →
`train_flow_mle` (batch 256, Adam(1e-3)) → a masked-autoregressive flow
(5 layers, [32,32]; log_prob in one MADE pass a layer). The score to beat
is the target's own E_p[log p], the largest held-out log-likelihood.

    python -m normalizingflows_torch.examples.demo_maf_mle --iters 500
"""

import tempfile
from pathlib import Path

import torch

import normalizingflows_torch as nft
from normalizingflows_torch.examples import _cli
from normalizingflows_torch.utils.data import make_loader, to_raw_file


def main(max_iters: int, seed: int = 123, device=None, plot=None,
         show_progress: bool = True, data_path=None):
    """``data_path``: where the raw file goes (default: the temporary
    directory's ``maf_mle_banana.raw``, as the JAX demo's)."""
    dtype = torch.float32
    gen_init, gen = _cli.generators(seed, device)

    target = nft.Banana(2, 1.0, 10.0)
    n_train, batch = 65536, 256
    data = target.sample(gen, (n_train,))
    path = str(data_path or Path(tempfile.gettempdir())
               / "maf_mle_banana.raw")
    to_raw_file(path, data.cpu().numpy())
    loader = make_loader(path, batch, n_rows=n_train, dim=2, seed=seed)

    flow = nft.maf(gen_init, nft.DiagNormal.standard(2, dtype, device),
                   (32, 32), nlayers=5, dtype=dtype, device=device)
    before_flow = _cli.untrained(flow, plot)

    heldout = target.sample(gen, (8192,))
    with torch.no_grad():
        optimum = float(target.log_prob(heldout).mean())  # E_p[log p]
        before = float(nft.loglikelihood(flow, heldout))

    res = nft.train_flow_mle(
        flow, loader, max_iters=max_iters, optimizer=nft.optim.adam(1e-3),
        check_every=max(max_iters // 20, 1), show_progress=show_progress,
    )
    with torch.no_grad():
        after = float(nft.loglikelihood(res.flow, heldout))
    loader.close()
    print(f"held-out mean log-lik  before: {before:.4f}  "
          f"after {max_iters} iters: {after:.4f}  "
          f"(target E_p[log p] = {optimum:.4f}, epochs = "
          f"{max_iters * batch / n_train:.1f})")
    if plot:
        _cli.plot(plot, res.flow, before_flow, target, res.stats, device)
    return res


if __name__ == "__main__":
    a = _cli.parser(__doc__, 500).parse_args()
    main(a.iters, device=a.device, plot=a.plot)
