"""Mean host ms of one frozen-backbone pass (``packppi.affinity.backbone``; wild
type and mutant, 2 a batch) in the profiled stretch."""
from perfbench.harness import program


def read(ctx):
    return program.span_ms(ctx, "affinity.backbone")
