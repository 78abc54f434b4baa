"""A sampling call's share of the card's float32 peak: the conditioners'
forward matmul FLOPs a call times the calls in the traced window, over
the window, over 67 TFLOP/s."""


def read(ctx):
    cell, tr = ctx.cell, ctx.trace
    if cell.traffic["kind"] != "sample" or not tr.units:
        return None
    flops = ctx.work.forward_flops(cell.config, cell.traffic["batch"])
    return 100.0 * flops * tr.units / tr.window_s / ctx.peaks.F32_PER_S
