"""Mean host ms of one Adam step of the refinement (``packppi.refine.step``: from
``zero_grad`` to ``opt.step()``; 50 a request) in the profiled stretch."""
from perfbench.harness import program


def read(ctx):
    return program.span_ms(ctx, "refine.step")
