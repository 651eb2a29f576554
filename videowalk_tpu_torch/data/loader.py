"""Threaded prefetching data loader (counterpart of
``videowalk_tpu/data/loader.py``; stands in for the reference's torch
``DataLoader`` of ``workers // 2`` processes, ``code/train.py:225-232``).

cv2 decode and the numpy transforms release the GIL, so a thread pool
overlaps them with the card's work without pickling batches between
processes. Batches are collated into contiguous numpy arrays; the
``data/prefetch.py`` prefetcher copies them to the card.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np


def default_collate(items: Sequence):
    """Stack a list of samples into batch arrays (dicts, tuples, arrays)."""
    first = items[0]
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate(list(col)) for col in zip(*items))
    if isinstance(first, np.ndarray):
        return np.stack(items)
    return np.asarray(items)


class DataLoader:
    """Iterate ``dataset[i]`` for i from ``sampler`` (or ``range(len)``) in
    batches, prefetching ``prefetch_batches`` with ``num_workers`` threads.

    ``shard=(rank, world)``: every process draws the same sampler sequence,
    takes its strided slice and cuts it to the common floor length, so all
    processes take the same number of steps. An exception in a worker is
    raised in the consumer at its batch's place."""

    def __init__(self, dataset, batch_size: int, sampler: Iterable | None = None,
                 num_workers: int = 4, collate_fn: Callable = default_collate,
                 drop_last: bool = True, prefetch_batches: int = 2,
                 shard: tuple[int, int] | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        if shard is not None:
            rank, world = shard
            if not 0 <= rank < world:
                raise ValueError(f"shard rank {rank} not in [0, {world})")
        self.shard = shard

    def _indices(self):
        base = (list(iter(self.sampler)) if self.sampler is not None
                else list(range(len(self.dataset))))
        if self.shard is not None:
            rank, world = self.shard
            base = base[rank::world][:len(base) // world]
        return base

    def __len__(self):
        # len(sampler), never a draw of it: drawing advances its RNG
        n = (len(self.sampler) if self.sampler is not None
             else len(self.dataset))
        if self.shard is not None:
            n = n // self.shard[1]
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        indices = self._indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def _put(item) -> bool:
            """A bounded put that sees the consumer leave (``stop``)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__,
                                              batch_idx))
                        if not _put(self.collate_fn(items)):
                            return
            except BaseException as e:  # noqa: BLE001 - raised in the consumer
                _put(e)
                return
            _put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            # drain so that a producer blocked in _put sees stop, then join,
            # so that the next epoch's pool does not overlap this one's
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=30.0)
