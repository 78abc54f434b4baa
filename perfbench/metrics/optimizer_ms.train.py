"""Adam's device milliseconds a training step (`kernels.optimizer`)."""

from perfbench import kernels


def read(ctx):
    tr = ctx.trace
    if ctx.cell.traffic["kind"] != "train_elbo" or not tr.units \
            or not tr.count(kernels.optimizer):
        return None
    return 1e3 * tr.seconds(kernels.optimizer) / tr.units
