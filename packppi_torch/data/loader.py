"""Bucketed batch loader with background prefetch.

Batches are grouped by length bucket (``data.batch.LENGTH_BUCKETS``), so a
run sees a handful of shapes. Within an epoch, proteins are shuffled with a
seeded generator, grouped into same-bucket batches, and the batch order is
shuffled again. A background thread overlaps host featurization, stacking
and the copy to the device with the device's work; it ends when the
iterator ends, is closed or is garbage-collected.
"""
from __future__ import annotations

import functools
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from packppi_torch.data.batch import bucket_length, stack_batch


class BucketedLoader:
    """Iterates ``ProteinBatch`` (or custom-stacked) batches over a dataset.

    Args:
        dataset: indexable returning feature dicts.
        batch_size: proteins per batch (same-bucket).
        device: where the default stacking puts a batch.
        shuffle: reshuffle each epoch (seeded).
        drop_last: drop trailing incomplete batches.
        stack_fn: ``(features list, target_len=...) -> batch`` (default:
            ``stack_batch`` onto ``device``).
        prefetch: number of batches prepared ahead on a worker thread.
        rows: a rank's rows of each batch (``parallel.batch_rows``): the
            plan and the padded length are the whole batch's, and only
            these rows are read and stacked.
    """

    def __init__(self, dataset, batch_size: int, device="cpu", shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False,
                 stack_fn: Optional[Callable] = None, prefetch: int = 2,
                 rows: Optional[slice] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.stack_fn = stack_fn or functools.partial(stack_batch, device=device)
        self.prefetch = prefetch
        self.rows = rows
        self.epoch = 0
        self._lengths: Optional[list[int]] = None

    def _ensure_lengths(self):
        if self._lengths is None:
            lengths = getattr(self.dataset, "lengths", None)
            if lengths is not None:
                # manifest-backed parse-only counts (ComplexDataset.lengths):
                # planning never featurizes the whole corpus serially
                self._lengths = list(lengths() if callable(lengths) else lengths)
            else:
                self._lengths = [len(self.dataset[i]["residue_type"])
                                 for i in range(len(self.dataset))]

    def _plan(self) -> list[list[int]]:
        """Same-bucket batches of dataset indices for this epoch."""
        self._ensure_lengths()
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        by_bucket: dict[int, list[int]] = {}
        for i in idx:
            by_bucket.setdefault(bucket_length(self._lengths[i]), []).append(int(i))
        batches = []
        for members in by_bucket.values():
            for s in range(0, len(members), self.batch_size):
                chunk = members[s:s + self.batch_size]
                if len(chunk) == self.batch_size or not self.drop_last:
                    batches.append(chunk)
        if self.shuffle:
            np.random.default_rng(self.seed * 7919 + self.epoch).shuffle(batches)
        return batches

    def __len__(self) -> int:
        return len(self._plan())

    def plan(self) -> list[list[int]]:
        """The dataset-index batches the NEXT ``__iter__`` will yield, in order."""
        return self._plan()

    def _make(self, batch_idx):
        if self.rows is not None:
            self._ensure_lengths()
            target = max(bucket_length(self._lengths[i]) for i in batch_idx)
            return self.stack_fn([self.dataset[i] for i in batch_idx[self.rows]],
                                 target_len=target)
        feats = [self.dataset[i] for i in batch_idx]
        target = max(bucket_length(len(f["residue_type"])) for f in feats)
        return self.stack_fn(feats, target_len=target)

    def first_batch(self):
        """First batch of the current plan, built synchronously (None if the
        plan is empty): for shape and initialisation templates, with no
        iterator and so no worker thread."""
        batches = self._plan()
        return self._make(batches[0]) if batches else None

    def __iter__(self) -> Iterator:
        batches = self._plan()
        self.epoch += 1
        if self.prefetch <= 0:
            for b in batches:
                yield self._make(b)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        cancelled = threading.Event()

        def put(item) -> bool:
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            # a worker failure must surface in the consumer, not silently
            # truncate the epoch
            try:
                for b in batches:
                    if not put(self._make(b)):
                        return
                put(done)
            except BaseException as e:  # noqa: BLE001 (re-raised in the consumer)
                put(e)

        t = threading.Thread(target=worker, daemon=True, name="packppi-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # reached at exhaustion, on an error, and when the consumer
            # abandons the iterator (close / garbage collection): the worker
            # sees the flag within one put timeout and ends
            cancelled.set()
            t.join()
