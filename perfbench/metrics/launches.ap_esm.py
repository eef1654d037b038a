"""Kernel launches a batch in the profiled stretch: every launch counter of
the program, summed (33 attention launches a forward)."""
from perfbench.harness import program


def read(ctx):
    return program.launches(ctx)
