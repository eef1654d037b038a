"""Share of the profiled stretch in which nothing ran on the device: 1
minus the union of device intervals over its wall time, in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
