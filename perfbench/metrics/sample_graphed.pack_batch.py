"""Share of the profiled stretch's ODE steps of the sampler (30 a chunk of 16 rows) that ran
as replays of a captured CUDA graph rather than eagerly: the growth of the
program's ``trace.engagement()`` over the stretch, the sampler's replays
over its replays and eager steps. None where the program does not count
them (a checkout older than the sampler's graphs) or ran no step."""
from perfbench.harness import program


def read(ctx):
    rep = program._report(ctx)
    eng = rep.get("engagement") if rep is not None else None
    if not eng or "sample_graph_replays" not in eng:
        return None
    steps = eng["sample_graph_replays"] + eng["sample_eager_steps"]
    return eng["sample_graph_replays"] / steps if steps else None
