"""Share of the profiled stretch's Adam steps of the refinement (50 a request)
that ran as replays of a captured CUDA graph rather than eagerly: the
growth of the program's ``trace.engagement()`` over the stretch, replays
over replays and eager steps. None where the program does not count them
(a checkout older than the graphs) or ran no step."""
from perfbench.harness import program


def read(ctx):
    rep = program._report(ctx)
    eng = rep.get("engagement") if rep is not None else None
    steps = eng["graph_replays"] + eng["eager_steps"] if eng else 0
    return eng["graph_replays"] / steps if steps else None
