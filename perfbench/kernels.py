"""Device operations by name, as the profiler reports them: the port's
kernels by their CUDA function names (`csrc/`), cuBLAS's GEMMs and the
foreach kernels of `torch.optim.Adam`."""

from __future__ import annotations


def k1(name: str) -> bool:
    """K1, the RQS forward (`rqs_fwd`)."""
    return "rqs_fwd" in name


def k2(name: str) -> bool:
    """K2, the RQS VJP in the forward direction (`rqs_bwd_fwddir`)."""
    return "rqs_bwd_fwddir" in name


def k4(name: str) -> bool:
    """K4, the coupling stack's forward (`coupling_fwd`, its lane and
    tensor-core variants)."""
    return "coupling_fwd" in name


def k5(name: str) -> bool:
    """K5, the coupling stack's VJP (`coupling_bwd`, `_rows`, `_reduce`)."""
    return "coupling_bwd" in name


_GEMM = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitkreduce")


def gemm(name: str) -> bool:
    low = name.lower()
    return any(g in low for g in _GEMM)


def optimizer(name: str) -> bool:
    """Adam's foreach kernels; the step's gradient norm (`_foreach_norm`,
    an Lp-norm functor and its clean-up) is not the optimizer's."""
    low = name.lower()
    return "multi_tensor_apply" in low and "norm" not in low
