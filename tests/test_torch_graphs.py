"""The one CUDA-graph cache and the static copies a replay loads
(``packppi_torch.device``), on the CPU with a fake capture: an entry reused
for its key, made again where it is no longer valid, the least recently
used dropped beyond eight, one capture a key under concurrent requests, and
a request copied into its static copies place by place. The replays
themselves run on the card only (``test_torch_proximal_gpu.py``,
``test_torch_sampler_gpu.py``)."""
import sys
import threading
import time
from typing import NamedTuple, Optional

import torch

from packppi_torch.device import _MAX_GRAPHS, GraphCache, _load, static_copies

from torch_threads import _threads  # noqa: F401 (autouse fixture)


class _Maker:
    """A fake capture: each call makes a new entry and is counted by key."""

    def __init__(self, pause=0.0):
        self.made, self.pause, self.lock = {}, pause, threading.Lock()

    def __call__(self, key):
        def make():
            time.sleep(self.pause)
            with self.lock:
                self.made[key] = self.made.get(key, 0) + 1
            return object()
        return make


def test_cache_reuses_the_entry_of_its_key():
    cache, make = GraphCache(), _Maker()
    first = cache.get((256, 1), make((256, 1)))
    assert cache.get((256, 1), make((256, 1))) is first
    assert cache.get((384, 1), make((384, 1))) is not first
    assert make.made == {(256, 1): 1, (384, 1): 1} and len(cache.entries) == 2


def test_cache_makes_again_where_the_entry_is_not_valid():
    """The sampler's check: an entry made under other weights is made
    again, in the same place, and the new one is kept."""
    cache, make = GraphCache(), _Maker()
    first = cache.get("k", make("k"), lambda e: True)
    second = cache.get("k", make("k"), lambda e: e is not first)
    assert second is not first and make.made == {"k": 2}
    assert cache.get("k", make("k"), lambda e: e is not first) is second
    assert list(cache.entries) == ["k"]


def test_cache_drops_the_least_recently_used_beyond_eight():
    cache, make = GraphCache(), _Maker()
    assert _MAX_GRAPHS == 8
    kept = {k: cache.get(k, make(k)) for k in range(_MAX_GRAPHS)}
    assert cache.get(0, make(0)) is kept[0]          # 0 is now the most recent
    cache.get(_MAX_GRAPHS, make(_MAX_GRAPHS))
    assert len(cache.entries) == _MAX_GRAPHS and 1 not in cache.entries
    assert cache.get(0, make(0)) is kept[0]
    cache.get(1, make(1))                             # made again, 2 dropped
    assert make.made[1] == 2 and make.made[0] == 1 and 2 not in cache.entries


def test_cache_makes_each_key_once_under_concurrent_gets():
    """Twelve threads ask for three keys at once, five times each, with the
    interpreter switching threads every 10 us and a capture that takes a
    millisecond: each key is made once, and every thread gets its entry."""
    cache, make = GraphCache(), _Maker(pause=1e-3)
    keys = [(256, 1), (384, 1), (768, 16)]
    got = [[] for _ in range(12)]

    def ask(i):
        for r in range(5):
            for k in keys[i % 3:] + keys[:i % 3]:
                got[i].append((k, cache.get(k, make(k))))

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(got))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert make.made == {k: 1 for k in keys}
    for pairs in got:
        assert len(pairs) == 15 and all(e is cache.entries[k] for k, e in pairs)


class _Graph(NamedTuple):
    a: torch.Tensor
    pair: Optional[tuple]
    gone: Optional[torch.Tensor]


class _Batch(NamedTuple):
    X: torch.Tensor
    mask: torch.Tensor
    unread: torch.Tensor


def test_static_copies_clone_what_a_step_reads_and_a_request_loads_into_them():
    """Of a batch only the fields a step reads are cloned, a nested pair is
    cloned whole and None stays None; loading a request of the same
    structure copies each tensor into its place and leaves the rest."""
    batch = _Batch(torch.arange(6.0).view(2, 3), torch.ones(2), torch.zeros(4))
    graph = _Graph(torch.full((2,), 3.0), (torch.tensor([1, 2]), torch.tensor([0.5])), None)
    sc = torch.zeros(2, 4)
    copies = (static_copies(batch, ("X", "mask")), static_copies(graph), static_copies(sc))
    assert type(copies[0]) is _Batch and type(copies[1]) is _Graph
    assert copies[0].unread is None and copies[1].gone is None
    for mine, theirs in ((copies[0].X, batch.X), (copies[1].pair[0], graph.pair[0]),
                         (copies[2], sc)):
        assert torch.equal(mine, theirs) and mine.data_ptr() != theirs.data_ptr()
    ptrs = [copies[0].X.data_ptr(), copies[1].pair[1].data_ptr(), copies[2].data_ptr()]

    request = (_Batch(batch.X + 10, batch.mask * 0, torch.full((4,), 7.0)),
               _Graph(graph.a - 1, (graph.pair[0] * 3, graph.pair[1] + 1), None), sc + 2)
    _load(copies, request)
    assert torch.equal(copies[0].X, request[0].X) and torch.equal(copies[0].mask, torch.zeros(2))
    assert copies[0].unread is None
    assert torch.equal(copies[1].a, torch.full((2,), 2.0))
    assert torch.equal(copies[1].pair[0], torch.tensor([3, 6]))
    assert torch.equal(copies[1].pair[1], torch.tensor([1.5]))
    assert torch.equal(copies[2], torch.full((2, 4), 2.0))
    # loaded in place: a captured graph reads the same memory
    assert ptrs == [copies[0].X.data_ptr(), copies[1].pair[1].data_ptr(), copies[2].data_ptr()]
