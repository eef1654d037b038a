"""The residual chains' least time (harness/costs.py) over the device
time of the kernels that do that work, in the profiled stretch, in %."""
from perfbench.harness import costs

KERNELS = ("chain_wgmma_kernel", "chain_f32_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_seconds(KERNELS)
    return 100.0 * costs.pass_bound_s(ctx.work, "chain") / t if t > 0 else None
