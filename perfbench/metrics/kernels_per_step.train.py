"""Device kernels a training step (memory copies and sets not counted)."""


def read(ctx):
    tr = ctx.trace
    if ctx.cell.traffic["kind"] != "train_elbo" or not tr.units \
            or not tr.kernels:
        return None
    return len(tr.kernels) / tr.units
