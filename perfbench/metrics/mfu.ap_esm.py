"""ESM-2's operations on the true tokens of each distinct sequence of each
batch and the head's (harness/costs_esm.py), completed in the window, over
its wall time and the float32 peak, in %."""


def read(ctx):
    w = ctx.window
    return 100.0 * w["flops"] / w["seconds"] / w["peak"] if w["flops"] else None
