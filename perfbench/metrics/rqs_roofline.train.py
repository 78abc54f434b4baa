"""K1 and K2 against their roofline in a training step: the least time
the card could take for the splines' forward and VJP of every coupling
(`work.rqs_bound_s`, from the shapes), over the device time of K1 and K2
in the traced window."""

from perfbench import kernels


def read(ctx):
    cell, tr, work = ctx.cell, ctx.trace, ctx.work
    if cell.traffic["kind"] != "train_elbo" or cell.config["family"] != "nsf":
        return None
    t = tr.seconds(kernels.k1) + tr.seconds(kernels.k2)
    if not t or not tr.units:
        return None
    K = cell.config["K"]
    bound = sum(work.rqs_bound_s("K1", n, K) + work.rqs_bound_s("K2", n, K)
                for n in work.rqs_elements(cell.config,
                                           cell.traffic["batch"]))
    return 100.0 * bound * tr.units / t
