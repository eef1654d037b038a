"""Mean host ms of one batched ESM-2 forward (``packppi.esm.embed``: tokens
in, residue rows on the device out; a batch's one) in the profiled
stretch."""
from perfbench.harness import program


def read(ctx):
    return program.span_ms(ctx, "esm.embed")
