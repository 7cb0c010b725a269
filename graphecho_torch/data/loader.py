"""Threaded prefetching batch loader, port of `graphecho_tpu/data/loader.py`.

Replaces the reference's `monai.data.DataLoader(num_workers=8)` worker pool:
a thread pool decodes/transforms samples (gzip inflation, numpy's copies and
the per-sample resize, which runs in the host C++ kernels of `data/native.py`
called through ctypes, release the GIL), batches are collated into numpy
arrays, and a small prefetch queue overlaps host decode with device steps.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, List, Sequence

import numpy as np


def collate(samples: Sequence[Any]) -> Any:
    """Stack a list of (image, mask, mask_index, index) tuples into arrays."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(collate([s[i] for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DataLoader:
    """Iterates batches of `dataset[i]` with shuffling and thread prefetch.

    `process_index`/`process_count` give per-host sharded loading for
    multi-process training — the replacement for the reference's
    DistributedSampler (`train_camus_echo.py:158-160`, which crashes on a
    nonexistent attribute and is never exercised): every host shuffles the
    SAME permutation (shared seed per epoch) and takes every
    `process_count`-th index, so global coverage per epoch is disjoint and
    complete while each host feeds only its local batch shard.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = max(process_count, 1)
        self._rng = np.random.RandomState(seed)

    def _local_size(self) -> int:
        n = len(self.dataset)
        if self.process_count == 1:
            return n
        # every rank takes exactly floor(n / count): unequal per-rank sizes
        # would give hosts different batch counts per epoch, and a host that
        # runs one more step than its peers deadlocks the collectives
        return n // self.process_count

    def __len__(self) -> int:
        n = self._local_size()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches_of_indices(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        if self.process_count > 1:
            # strided shard, truncated to the common per-rank size (see
            # _local_size: equal step counts across hosts are mandatory)
            idx = idx[self.process_index::self.process_count][:self._local_size()]
        out = []
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                break
            out.append(list(chunk))
        return out

    def __iter__(self) -> Iterator[Any]:
        batches = self._batches_of_indices()
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that keeps checking the stop flag: a consumer that
            # abandons iteration mid-epoch (init_state's single next(), an
            # exception, preemption) must not leave this thread blocked
            # forever on a full prefetch queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # any exception (dataset.__getitem__ raising inside pool.map
            # included) is forwarded to the consumer — a dead producer must
            # never leave the consumer blocked forever on q.get()
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__,
                                                batch_idx))
                        if not put(collate(samples)):
                            return
                put(None)
            except BaseException as exc:  # noqa: BLE001 — forwarded, not hidden
                put(exc)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def cycled(loader: DataLoader) -> Iterator[Any]:
    """Endless iterator (the reference re-creates target iterators per epoch,
    `train_camus_echo.py:192-201`; cycling is equivalent and simpler)."""
    while True:
        produced = False
        for item in loader:
            produced = True
            yield item
        if not produced:
            raise ValueError(
                "cycled(): loader produced no batches (dataset smaller than "
                "batch_size with drop_last=True, or empty dataset)")


def rebatched(it: Iterator[Any], n: int) -> Iterator[Any]:
    """Re-chunk an endless iterator of collated tuple-batches into batches of
    EXACTLY n rows (leading dim), buffering rows across incoming batches.

    Tail batches from `drop_last=False` loaders otherwise change the leading
    dim of the train step's inputs (the TGCN splits its clip batch at the
    midpoint, so source and target halves must match). Feeding through this
    adapter keeps every step batch the same shape without dropping data;
    upstream must be `cycled(...)` so the stream never ends.
    """
    buf = None
    while True:
        batch = next(it)
        if not isinstance(batch, tuple):
            batch = (batch,)
        buf = batch if buf is None else tuple(
            np.concatenate([a, b], axis=0) for a, b in zip(buf, batch))
        while buf[0].shape[0] >= n:
            yield tuple(a[:n] for a in buf)
            buf = tuple(a[n:] for a in buf)
