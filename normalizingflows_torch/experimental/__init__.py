"""The fused RealNVP path (counterpart of `jl_tpu/experimental/`).

* `coupling_cuda`: the fused coupling-stack kernels K4/K5
  (`csrc/coupling.cu`) with their plain versions.
* `fused_flow`: the `FusedRealNVP` bijector that drives them;
  `realnvp(..., fused=True)` builds one.

The JAX package retired its Pallas versions of these kernels after TPU
measurements; on the card they are the path ``fused=True`` takes, and
their times stand in `PERF.md`. The whole-run training kernel
(`train_realnvp_fused`) is not ported yet.
"""

from .fused_flow import FusedRealNVP

__all__ = ["FusedRealNVP"]
