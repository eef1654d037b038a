"""Kernel launches a request in the profiled stretch: every launch counter of
the program, summed (message, chain, clash forward and gradient)."""
from perfbench.harness import program


def read(ctx):
    return program.launches(ctx)
