"""Spans and counters of the program, live only while a torch profiler records.

``span(name)`` marks a stretch of host work at the site that does it::

    with span("sample.step"):
        ...

With no profiler recording it is one check of torch's profiler flag
(``torch.autograd.profiler._is_profiler_enabled``, which
``torch.profiler.profile`` sets for its duration): it marks the live stretch
ended and returns one shared no-op context, and reads no clock, opens no
annotation and allocates nothing.
Under a recording profiler it opens ``record_function("packppi." + name)``,
so the span lies in the profiler's trace beside the kernels it launched, and
keeps a ``Span`` in memory: its name, ``time.time_ns()`` stamps (the clock
the profiler's exported Chrome trace is built on: an event lies at ``ts``
microseconds after the trace's ``baseTimeNanoseconds``), the native id of
the thread that did the work and the enclosing live span of that thread.
The profiler records annotations of the thread that started it only; the
spans in memory hold every thread's.

A live stretch starts at the first span opened under a recording profiler
after one opened without: it drops what the last stretch kept and takes
``counters()`` and ``engagement()`` as the stretch's start. Each outermost
span that closes takes them again as the stretch's end. ``report()`` and
``records()`` read the last live stretch and clear nothing.

``engagement()`` counts how the refinement's Adam steps ran (CUDA graphs
captured, graph replays, eager steps) and, under keys of their own, how the
sampler's ODE steps ran (``sample_*``) and how PackPPI-AP's backbone and
mutation passes ran (``affinity_*``); ``tally(name)`` adds one.
They are kept apart from ``counters()``, whose every entry is a kernel
launch. ``add_launches`` adds to the launch counters what a CUDA graph's
replay launched, which no wrapper counts.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import NamedTuple, Optional

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int               # time.time_ns() at entry
    end_ns: int
    thread: int                 # threading.get_native_id(): the trace's ``tid``
    parent: Optional[str]       # the enclosing live span on the same thread


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.live = False
        self.spans: list = []
        self.start: tuple = ({}, {})      # (counters(), engagement())
        self.end: tuple = ({}, {})
        self.local = threading.local()     # each thread's stack of open span names

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def go_live(self) -> None:
        with self.lock:
            if not self.live:
                self.spans = []
                self.start = self.end = (counters(), engagement())
                self.live = True


_REC = _Recorder()


class _Live:
    __slots__ = ("name", "parent", "start_ns", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if not _REC.live:
            _REC.go_live()
        stack = _REC.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.annotation = record_function("packppi." + self.name)
        self.annotation.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self.annotation.__exit__(*exc)
        _REC.stack().pop()
        span = Span(self.name, self.start_ns, end_ns, threading.get_native_id(), self.parent)
        with _REC.lock:
            _REC.spans.append(span)
            if self.parent is None:
                _REC.end = (counters(), engagement())
        return False


def span(name: str):
    """A context around host work named ``name``; live only while a torch
    profiler records."""
    if not _profiler._is_profiler_enabled:
        _REC.live = False
        return _OFF
    return _Live(name)


@functools.lru_cache(maxsize=None)
def _counter_sites() -> dict:
    """Each launch counter by name: the object and attribute that hold it."""
    from packppi_torch.ops import attention, chain, clash, gemm, layer, message, message_feat

    brc = clash.between_residue_clash
    return {"message": (message.message, "launches"),
            "message_gather": (message.message_gather, "launches"),
            "message_geom": (message.message_geom, "launches"),
            "message_chain": (message.message_chain, "launches"),
            "message_feat": (message_feat.message_feat, "launches"),
            "chain": (chain.chain, "launches"), "layer_node": (layer.layer_node, "launches"),
            "layer_edge": (layer.layer_edge, "launches"), "attention": (attention.mha, "launches"),
            "clash_fwd": (brc, "launches_fwd"), "clash_bwd": (brc, "launches_bwd"),
            "gemm": (gemm.linear, "launches")}


def counters() -> dict:
    """Every counter of the program by name: the launches of each kernel
    wrapper in ``ops/`` (clash forward and gradient apart)."""
    return {k: getattr(o, a) for k, (o, a) in _counter_sites().items()}


def add_launches(growth: dict) -> None:
    """Add ``growth`` (launches by the names of ``counters()``) to the
    counters: a CUDA graph's replay launches its kernels without their
    wrappers, and a capture's wrappers counted launches that never ran."""
    for k, (o, a) in _counter_sites().items():
        if growth.get(k):
            setattr(o, a, getattr(o, a) + growth[k])


_ENGAGED = {"graph_captures": 0, "graph_replays": 0, "eager_steps": 0,
            "sample_graph_captures": 0, "sample_graph_replays": 0, "sample_eager_steps": 0,
            "affinity_graph_captures": 0, "affinity_graph_replays": 0,
            "affinity_eager_passes": 0}


def tally(name: str) -> None:
    """One more event ``name`` of ``engagement()``."""
    _ENGAGED[name] += 1


def engagement() -> dict:
    """How the refinement's Adam steps ran, by name: CUDA graphs captured
    (one a shape), steps run as a replay of one, and steps run eagerly; the
    same for the sampler's ODE steps under ``sample_graph_captures``,
    ``sample_graph_replays`` and ``sample_eager_steps``, and for
    PackPPI-AP's backbone and mutation passes (three a prediction) under
    ``affinity_graph_captures``, ``affinity_graph_replays`` and
    ``affinity_eager_passes``."""
    return dict(_ENGAGED)


def records() -> list:
    """The ``Span``s of the last live stretch, in the order they closed."""
    with _REC.lock:
        return list(_REC.spans)


def report() -> dict:
    """The last live stretch: ``{"spans": {name: {"n", "total_s"}},
    "counters": {name: growth from the stretch's start to its end},
    "engagement": {name: the same for ``engagement()``}}``."""
    with _REC.lock:
        spans, start, end = list(_REC.spans), _REC.start, _REC.end
    out: dict = {}
    for s in spans:
        d = out.setdefault(s.name, {"n": 0, "total_s": 0.0})
        d["n"] += 1
        d["total_s"] += (s.end_ns - s.start_ns) * 1e-9
    growth = [{k: e[k] - v for k, v in s.items()} for s, e in zip(start, end)]
    return {"spans": out, "counters": growth[0], "engagement": growth[1]}
