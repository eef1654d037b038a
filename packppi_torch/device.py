"""Device resolution with no silent CPU fallback.

Entry points run on the card unless the caller asks for the CPU by name.
Without a usable GPU, a request for the default device raises instead of
quietly running the plain PyTorch path on the host.

On the card a loop of one step runs as replays of a CUDA graph (``Replay``)
captured once a shape and kept in a ``GraphCache``; a request is loaded
into static copies of what the step reads (``static_copies``).
"""
from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Callable, Optional, Union

import torch

from packppi_torch.utils.trace import add_launches, counters, span, tally

_MAX_GRAPHS = 8   # the captured shapes a cache keeps


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises without
    one); ``"cpu"`` -> the CPU, only when asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run the plain PyTorch path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


@functools.lru_cache(maxsize=None)
def _capture_stream(device) -> "torch.cuda.Stream":
    """The one side stream of ``device`` that every CUDA graph capture of
    the program warms up and captures on (cuBLAS keeps a workspace for each
    stream it meets)."""
    return torch.cuda.Stream(device)


def static_copies(x, fields=None):
    """Clones of the tensors of ``x``: a tensor, None, or a tuple or
    NamedTuple of these, nested. Of a NamedTuple ``x`` only the fields named
    in ``fields`` (default: all) are cloned; the others become None."""
    if not isinstance(x, tuple):
        return None if x is None else x.clone()
    names = getattr(x, "_fields", None)
    out = [static_copies(v) if fields is None or n in fields else None
           for n, v in zip(names or x, x)]
    return type(x)(*out) if names else tuple(out)


def _load(copies, x) -> None:
    """Copies each tensor of ``x`` into its place in ``copies`` (made by
    ``static_copies``), leaving out the places that hold None."""
    if isinstance(copies, tuple):
        for c, v in zip(copies, x):
            _load(c, v)
    elif copies is not None:
        copies.copy_(x)


def weight_versions(module: torch.nn.Module) -> tuple:
    """Each parameter of ``module``'s address and version (-1 for an
    inference tensor, which has none): a step captured under one reading
    is captured again once a parameter is another tensor or was written in
    place (the kernels' packed weight copies are made outside the graph)."""
    return tuple((p.data_ptr(), -1 if p.is_inference() else p._version)
                 for p in module.parameters())


class GraphCache:
    """Captured steps by key under one lock, so that a key is captured once
    however many threads ask for it; the least recently used beyond
    ``_MAX_GRAPHS`` is dropped with its memory."""

    def __init__(self):
        self.entries: "OrderedDict[tuple, object]" = OrderedDict()
        self.lock = threading.Lock()

    def get(self, key, make: Callable[[], object],
            valid: Optional[Callable[[object], bool]] = None):
        """The entry of ``key``, made by ``make()`` on a miss and where
        ``valid(entry)`` is false."""
        with self.lock:
            entry = self.entries.get(key)
            if entry is None or (valid is not None and not valid(entry)):
                entry = self.entries[key] = make()
                if len(self.entries) > _MAX_GRAPHS:
                    self.entries.popitem(last=False)
            self.entries.move_to_end(key)
        return entry


class Replay:
    """``step`` captured into a CUDA graph on ``device``'s capture stream,
    after two eager runs of ``warm_up`` (default ``step``) there (cuBLAS's
    workspace, kernel libraries, packed weights), and replayed for one
    request at a time. ``copies``: the static copies (``static_copies``)
    that ``step`` reads and each request is loaded into. ``launches``: the
    kernel launches a replay makes, by the names of ``trace.counters()``;
    the warm-up's and the capture's own are taken off the counters again,
    since they are set-up.

    A lock keeps a shape's requests apart, and an event keeps a request on
    another stream from loading the copies before the last one's results
    are cloned out. Each replay opens span ``span_name`` and counts
    ``prefix + "graph_replays"`` in ``engagement()``, the capture
    ``prefix + "graph_captures"``."""

    def __init__(self, step: Callable[[], None], device, copies: tuple, span_name: str,
                 prefix: str = "", warm_up: Optional[Callable[[], None]] = None):
        before = counters()
        side = _capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                (warm_up or step)()
        torch.cuda.current_stream(device).wait_stream(side)
        warm = counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
            step()
        after = counters()
        add_launches({k: before[k] - after[k] for k in after})
        self.launches = {k: after[k] - warm[k] for k in after}
        tally(prefix + "graph_captures")
        self.device, self.copies = device, copies
        self.span_name, self.replays = span_name, prefix + "graph_replays"
        self.lock, self.done = threading.Lock(), torch.cuda.Event()

    def run(self, request: tuple, n_steps: int, out: Callable[[], object],
            each: Optional[Callable[[int], None]] = None, zero: tuple = ()):
        """Loads ``request`` (of the copies' structure) into the copies and
        zeroes the tensors ``zero``; then ``n_steps`` replays, each after
        ``each(i)``. Returns ``out()``, the request's results as tensors of
        its own."""
        with self.lock, torch.no_grad():
            torch.cuda.current_stream(self.device).wait_event(self.done)
            _load(self.copies, request)
            for t in zero:
                t.zero_()
            for i in range(n_steps):
                with span(self.span_name):
                    if each is not None:
                        each(i)
                    self.graph.replay()
                    add_launches(self.launches)
                    tally(self.replays)
            result = out()
            self.done.record()
            return result
