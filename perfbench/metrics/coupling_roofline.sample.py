"""K4 against its roofline in a sampling call: the least time the card
could take for the coupling stack's forward (`work.coupling_bound_s`),
over K4's device time in the traced window."""

from perfbench import kernels


def read(ctx):
    cell, tr, work = ctx.cell, ctx.trace, ctx.work
    if cell.traffic["kind"] != "sample" or cell.config["family"] != "realnvp":
        return None
    t = tr.seconds(kernels.k4)
    if not t or not tr.units:
        return None
    bound = work.coupling_bound_s("K4", cell.config, cell.traffic["batch"])
    return 100.0 * bound * tr.units / t
