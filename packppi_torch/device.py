"""Device resolution with no silent CPU fallback.

Entry points run on the card unless the caller asks for the CPU by name.
Without a usable GPU, a request for the default device raises instead of
quietly running the plain PyTorch path on the host.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import torch


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


def capture_graph(step: Callable[[], None], device,
                  warm_up: Optional[Callable[[], None]] = None):
    """``step`` captured into a CUDA graph on ``device``'s capture stream,
    after two eager runs of ``warm_up`` (default ``step``) there (cuBLAS's
    workspace, kernel libraries, packed weights). Returns the graph
    and the kernel launches one replay makes, by the names of
    ``trace.counters()``; the warm-up's and the capture's own launches are
    taken off the counters again, since they are set-up."""
    from packppi_torch.utils import trace

    before = trace.counters()
    side = _capture_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(2):
            (warm_up or step)()
    torch.cuda.current_stream(device).wait_stream(side)
    warm = trace.counters()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        step()
    after = trace.counters()
    trace.add_launches({k: before[k] - after[k] for k in after})
    return graph, {k: after[k] - warm[k] for k in after}
