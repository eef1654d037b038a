"""The attention passes' least time (harness/costs_esm.py: operations over
the float32 peak or bytes over the bandwidth, from shapes, padded keys
included) over the device time of the kernel that does that work, in the
profiled stretch, in %."""
from perfbench.harness import costs_esm

KERNELS = ("mha_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_seconds(KERNELS)
    return 100.0 * costs_esm.attention_bound_s(ctx.work) / t if t > 0 else None
