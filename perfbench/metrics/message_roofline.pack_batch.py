"""The message passes' least time (harness/costs.py: bytes over the
bandwidth or operations over the peak, from shapes) over the device time of
the kernels that do that work, in the profiled stretch, in %."""
from perfbench.harness import costs

KERNELS = ("message_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_seconds(KERNELS)
    return 100.0 * costs.pass_bound_s(ctx.work, "message") / t if t > 0 else None
