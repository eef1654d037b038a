"""The model's operations on true rows (harness/costs.py) completed in the
window, over its wall time and the dtype's published peak, in %."""


def read(ctx):
    w = ctx.window
    return 100.0 * w["flops"] / w["seconds"] / w["peak"] if w["flops"] else None
