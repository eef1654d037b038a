"""Share of the profiled stretch's PackPPI-AP passes (three a batch: the
backbone on the wild type and on the mutant, the mutation stack) that ran
as replays of a captured CUDA graph rather than eagerly: the growth of the
program's ``trace.engagement()`` over the stretch, the ``affinity_*``
replays over replays and eager passes. None where the program does not
count them (a checkout older than the affinity graphs) or ran no pass."""
from perfbench.harness import program


def read(ctx):
    rep = program._report(ctx)
    eng = rep.get("engagement") if rep is not None else None
    if not eng or "affinity_graph_replays" not in eng:
        return None
    passes = eng["affinity_graph_replays"] + eng["affinity_eager_passes"]
    return eng["affinity_graph_replays"] / passes if passes else None
