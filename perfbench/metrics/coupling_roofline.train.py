"""K4 and K5 against their roofline in a training step: the least time
the card could take for the coupling stack's forward and VJP
(`work.coupling_bound_s`, from the shapes), over the device time of K4
and K5 in the traced window."""

from perfbench import kernels


def read(ctx):
    cell, tr, work = ctx.cell, ctx.trace, ctx.work
    if cell.traffic["kind"] != "train_elbo" \
            or cell.config["family"] != "realnvp":
        return None
    t = tr.seconds(kernels.k4) + tr.seconds(kernels.k5)
    if not t or not tr.units:
        return None
    n = cell.traffic["batch"]
    bound = (work.coupling_bound_s("K4", cell.config, n)
             + work.coupling_bound_s("K5", cell.config, n))
    return 100.0 * bound * tr.units / t
