"""Share of the traced training window in which no operation ran on the
device."""


def read(ctx):
    tr = ctx.trace
    if ctx.cell.traffic["kind"] != "train_elbo" or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
