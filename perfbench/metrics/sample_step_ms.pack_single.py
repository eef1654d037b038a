"""Mean host ms of one ODE step of the sampler (``packppi.sample.step``: the network
call, both schedule steps and the wrap; 30 a request) in the profiled stretch."""
from perfbench.harness import program


def read(ctx):
    return program.span_ms(ctx, "sample.step")
