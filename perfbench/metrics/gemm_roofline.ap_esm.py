"""ESM-2's linear maps' least time (harness/costs_gemm.py: operations over
the float32 peak or bytes over the bandwidth, from shapes, padded tokens
included) over the device time of the kernel that computes them, the
3xTF32 GEMM of ``csrc/gemm.cu``, in the profiled stretch, in %. None where
that kernel did not run (a checkout whose maps go to cuBLAS)."""
from perfbench.harness import costs_gemm

KERNELS = ("gemm_tf32x3_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_seconds(KERNELS)
    return 100.0 * costs_gemm.gemm_bound_s(ctx.work) / t if t > 0 else None
