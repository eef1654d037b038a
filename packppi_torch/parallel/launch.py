"""Ranks: start-up, rendezvous, the device of each rank, and the collectives.

An XLA mesh is one process that owns every device; here each rank is a
process of its own. ``launch(fn, n_ranks, device)`` spawns ``n_ranks``
processes (spawn start method), joins them in one process group over a
rendezvous at ``tcp://127.0.0.1:<free port>``, runs ``fn(*args)`` in each
and returns what every rank returned, in rank order. Inside a rank,
``current()`` is its ``Rank``.

The device of rank r is ``cuda:r`` (made current before anything touches
the card) and the backend NCCL; on the CPU every rank runs on the host over
gloo. NCCL takes one card a rank: with more ranks than cards ``launch``
raises, unless ``share_device=True`` is passed, which puts every rank on
``cuda:0`` over gloo (for checks on a one-card machine; it is never chosen
for the caller).

Kernel libraries are built once: rank 0 builds the ones named in
``kernels`` while the other ranks wait, and a failed build fails every rank.

The collective helpers below take a ``group`` (a ``Mesh`` axis or None for
the world). Gloo runs its collectives on host tensors: with gloo and a CUDA
tensor (``share_device``) they copy through host memory. NCCL never does.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

# the libraries rank 0 builds before the other ranks may launch a kernel
KERNELS = ("message", "message_feat", "chain", "layer", "clash", "attention")


@dataclasses.dataclass(frozen=True)
class Rank:
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def host_collectives(self) -> bool:
        """Collectives of CUDA tensors go through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"


_CURRENT: Optional[Rank] = None


def current() -> Optional[Rank]:
    """This process's rank, or None outside ``launch``."""
    return _CURRENT


def is_main() -> bool:
    """True on rank 0 and outside ``launch``: the process that writes files,
    logs and prints."""
    return _CURRENT is None or _CURRENT.is_main


def visible_devices(device_type: str) -> int:
    """Ranks a device type can hold: the visible cards, or 1 on the CPU."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return 1


def resolve_ranks(n: Optional[int], device: torch.device, what: str = "--n_devices",
                  share_device: bool = False) -> int:
    """``n`` ranks (None: every visible card, one on the CPU), a request above
    the visible cards clamped with a warning, as the JAX package clamps to
    ``jax.device_count()``. On the CPU any count runs (ranks over gloo), and
    so it does on the card with ``share_device``."""
    n = n or visible_devices(device.type)
    if n < 1:
        raise SystemExit(f"{what} must be >= 1 (got {n})")
    if device.type == "cuda" and n > visible_devices("cuda") and not share_device:
        print(f"WARNING: {what} {n} > available {visible_devices('cuda')}; clamping")
        n = visible_devices("cuda")
    return n


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(fn: Callable, n_ranks: int, device, *args, share_device: bool = False,
           kernels: Sequence[str] = KERNELS, threads: Optional[int] = None,
           timeout: float = 3600.0) -> list:
    """Run ``fn(*args)`` on ``n_ranks`` ranks and return each rank's result.

    ``device``: "cuda" or "cpu" (a torch device; its index is ignored).
    ``threads``: torch threads of each rank (default: this process's threads
    shared out among the ranks, at least one). A rank that raises fails the
    launch: the others are stopped and its traceback is raised here.
    """
    import torch.multiprocessing as mp

    device_type = torch.device(device).type
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device is available for the ranks; pass device='cpu'")
        if n_ranks > cards and not share_device:
            raise RuntimeError(
                f"{n_ranks} ranks on {cards} card(s): NCCL takes one card a rank; pass "
                "share_device=True to run the ranks on one card over gloo")
    backend = "nccl" if device_type == "cuda" and not share_device else "gloo"
    if threads is None:
        threads = max(1, torch.get_num_threads() // n_ranks)
    port = free_port()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="packppi_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=False,
                             args=(r, n_ranks, port, device_type, backend, share_device,
                                   threads, tuple(kernels), fn, args, tmp))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        results, errors = [], []
        for r, p in enumerate(procs):
            path = Path(tmp) / f"rank{r}.pkl"
            if path.exists():
                ok, value = pickle.loads(path.read_bytes())
                if ok:
                    results.append(value)
                    continue
                errors.append(f"rank {r} raised:\n{value}")
            else:
                errors.append(f"rank {r} ended with exit code {p.exitcode} and no result")
        if errors:
            raise RuntimeError("\n".join(errors))
        return results


def _rank_main(r, n, port, device_type, backend, share_device, threads, kernels, fn, args,
               tmp):
    global _CURRENT
    torch.set_num_threads(threads)
    if device_type == "cuda":
        device = torch.device("cuda", 0 if share_device else r)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=n, rank=r)
        _CURRENT = Rank(r, n, device, backend)
        if device_type == "cuda":
            _build_once(kernels)
        out = (True, fn(*args))
    except BaseException:  # noqa: BLE001 (the traceback goes back to the parent)
        out = (False, traceback.format_exc())
    try:
        payload = pickle.dumps(out)
    except Exception:  # noqa: BLE001 (an unpicklable result is an error too)
        payload = pickle.dumps((False, traceback.format_exc()))
    part = Path(tmp) / f"rank{r}.pkl.part"
    part.write_bytes(payload)
    os.replace(part, Path(tmp) / f"rank{r}.pkl")
    if dist.is_initialized():
        if out[0]:
            dist.destroy_process_group()
        else:
            # a failed rank leaves at once: the parent stops the others
            os._exit(1)
    if not out[0]:
        raise SystemExit(1)


def _build_once(kernels) -> None:
    """Rank 0 builds the kernel libraries; the others wait for its verdict.
    A build error on rank 0 raises on every rank."""
    from packppi_torch.ops import _build

    err = ""
    if _CURRENT.is_main:
        try:
            _build.build_all(kernels)
        except Exception as e:  # noqa: BLE001 (re-raised on every rank below)
            err = f"{type(e).__name__}: {e}"
    flag = [err]
    dist.broadcast_object_list(flag, src=0)
    if flag[0]:
        raise RuntimeError(f"kernel build failed on rank 0: {flag[0]}")


# ---- collectives ------------------------------------------------------------
# ``group`` is a process group (a Mesh axis) or None for the world. Under
# gloo with CUDA tensors each helper copies through host memory.

def _group_size(group) -> int:
    return dist.get_world_size(group)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if _CURRENT is not None and _CURRENT.host_collectives else t


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group``, in place; returns ``t``."""
    h = _host(t)
    dist.all_reduce(h, op=op, group=group)
    if h is not t:
        t.copy_(h)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The members' ``t`` concatenated along ``dim`` in group-rank order
    (every member's ``t`` has the same shape)."""
    h = _host(t.contiguous())
    if h.dtype == torch.bool:           # not every backend gathers bool
        h = h.to(torch.uint8)
    parts = [torch.empty_like(h) for _ in range(_group_size(group))]
    dist.all_gather(parts, h, group=group)
    return torch.cat(parts, dim).to(device=t.device, dtype=t.dtype)


def reduce_scatter(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The sum over ``group`` of ``t``, split along ``dim`` into one equal
    chunk a member: this member's chunk."""
    n = _group_size(group)
    h = _host(t)
    chunks = [c.contiguous() for c in h.chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out.to(t.device)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` of global rank ``src`` on every member, in place; returns ``t``."""
    h = _host(t)
    dist.broadcast(h, src=src, group=group)
    if h is not t:
        t.copy_(h)
    return t


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor a point-to-point op moves: bool as uint8."""
    h = _host(t.contiguous())
    return h.to(torch.uint8) if h.dtype == torch.bool else h


def send(t: torch.Tensor, dst: int) -> None:
    dist.send(_wire(t), dst=dst)


def recv(t: torch.Tensor, src: int) -> torch.Tensor:
    """Receive into ``t`` from global rank ``src``; returns ``t``."""
    h = _wire(t)
    dist.recv(h, src=src)
    if h is not t:
        t.copy_(h)
    return t


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
