"""Kernel launches a batch in the profiled stretch: every launch counter of
the program, summed (message and chain)."""
from perfbench.harness import program


def read(ctx):
    return program.launches(ctx)
