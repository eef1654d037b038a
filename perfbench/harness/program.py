"""What the program's own spans and launch counters say of the profiled
stretch (``packppi_torch.utils.trace``: spans live only while a torch
profiler records), for the per-layer metrics that read them. Each returns
None without a profiled stretch, or where the program has no such span or
counters (a checkout older than the module)."""
from __future__ import annotations


def _report(ctx):
    if ctx.trace is None:
        return None
    try:
        from packppi_torch.utils import trace
    except ImportError:
        return None
    return trace.report()


def span_ms(ctx, name: str):
    """Mean host ms of one span ``name`` (``packppi.<name>``) in the stretch."""
    rep = _report(ctx)
    s = rep["spans"].get(name) if rep is not None else None
    return 1e3 * s["total_s"] / s["n"] if s else None


def launches(ctx):
    """Kernel launches of the stretch (every counter's growth) over its
    requests, chunks or batches (``ctx.work``)."""
    rep = _report(ctx)
    return sum(rep["counters"].values()) / len(ctx.work) if rep is not None else None
