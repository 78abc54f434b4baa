"""cuBLAS's device milliseconds a training step (`kernels.gemm`): the
conditioners' matmuls, forward and backward."""

from perfbench import kernels


def read(ctx):
    tr = ctx.trace
    if ctx.cell.traffic["kind"] != "train_elbo" or not tr.units \
            or not tr.count(kernels.gemm):
        return None
    return 1e3 * tr.seconds(kernels.gemm) / tr.units
