"""Mean host ms of one complex's featurization (``packppi.structure.featurize``,
on the pool threads; 8 a chunk) in the profiled stretch."""
from perfbench.harness import program


def read(ctx):
    return program.span_ms(ctx, "structure.featurize")
