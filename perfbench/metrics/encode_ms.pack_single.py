"""Mean host ms of the sampler's encoder and static graph (``packppi.sample.encode``, once a
request) in the profiled stretch."""
from perfbench.harness import program


def read(ctx):
    return program.span_ms(ctx, "sample.encode")
