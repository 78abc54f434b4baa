"""The fused RealNVP path (counterpart of `jl_tpu/experimental/`).

* `coupling_cuda`: the fused coupling-stack kernels K4/K5
  (`csrc/coupling.cu`) with their plain versions.
* `train_cuda`: the whole-run training kernel K6 (`csrc/train.cu`,
  `csrc/train_bf16.cu`), many Adam/ELBO steps a launch on a Banana,
  Funnel or WarpedGauss target, with its plain version.
* `fused_flow`: the `FusedRealNVP` bijector that drives K4/K5
  (`realnvp(..., fused=True)` builds one) and `train_realnvp_fused`, which
  trains it through K6.

The JAX package retired its Pallas versions of these kernels after TPU
measurements; on the card they are the path ``fused=True`` and
`train_realnvp_fused` take, and their times stand in `PERF.md`.
"""

from .fused_flow import FusedRealNVP, train_realnvp_fused

__all__ = ["FusedRealNVP", "train_realnvp_fused"]
