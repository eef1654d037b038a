"""Mean host ms of one ODE step of the sampler over a chunk's 16 rows
(``packppi.sample.step``; 30 a chunk) in the profiled stretch."""
from perfbench.harness import program


def read(ctx):
    return program.span_ms(ctx, "sample.step")
