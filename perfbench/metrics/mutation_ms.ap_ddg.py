"""Mean host ms of the mutation network call (``packppi.affinity.mutation``: both
directions, once a batch) in the profiled stretch."""
from perfbench.harness import program


def read(ctx):
    return program.span_ms(ctx, "affinity.mutation")
