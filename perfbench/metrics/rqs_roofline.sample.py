"""K1 against its roofline in a sampling call: the least time the card
could take for every coupling's spline forward (`work.rqs_bound_s`),
over K1's device time in the traced window."""

from perfbench import kernels


def read(ctx):
    cell, tr, work = ctx.cell, ctx.trace, ctx.work
    if cell.traffic["kind"] != "sample" or cell.config["family"] != "nsf":
        return None
    t = tr.seconds(kernels.k1)
    if not t or not tr.units:
        return None
    K = cell.config["K"]
    bound = sum(work.rqs_bound_s("K1", n, K)
                for n in work.rqs_elements(cell.config,
                                           cell.traffic["batch"]))
    return 100.0 * bound * tr.units / t
