"""Mean host ms of one complex's PDB text (``packppi.structure.to_pdb``, on the
writer threads; 8 a chunk) in the profiled stretch."""
from perfbench.harness import program


def read(ctx):
    return program.span_ms(ctx, "structure.to_pdb")
