"""Host-to-device prefetch for the training loop (counterpart of
``videowalk_tpu/data/prefetch.py``; the reference's ``pin_memory`` and
asynchronous CUDA copies, ``code/train.py:225-232``).

A background thread takes batches from the loader ``size`` steps ahead,
copies the views the step consumes to the card from pinned host memory on a
side stream (``non_blocking``) and records an event after the copies. The
consumer's stream waits on that event before it uses a batch, and each
copied tensor is ``record_stream``-ed on the consumer's stream, so that the
caching allocator cannot hand its memory to a later copy while a step still
reads it. On the CPU the views become tensors without a copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from videowalk_tpu_torch.utils.device import resolve_device


def _copy(x, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else torch.as_tensor(x)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_device(item, keys, device: torch.device):
    """The consumed leaves of a ``(views, sp_mask, label)`` batch as tensors
    on ``device``: the views named in ``keys`` (all when None) and a mask
    batch; the other views and the label stay on the host, as numpy."""
    views, sp_mask, label = item
    views = {k: _copy(v, device) if keys is None or k in keys else v
             for k, v in views.items()}
    if sp_mask is not None and getattr(sp_mask, "ndim", 0) > 1:
        sp_mask = _copy(sp_mask, device)
    return views, sp_mask, label


def _tensors(item):
    views, sp_mask, _ = item
    return [t for t in (*views.values(), sp_mask) if torch.is_tensor(t)]


class DevicePrefetcher:
    """Wrap a batch iterable; copy batches to ``device`` ``size`` steps
    ahead. An exception of the loader is raised in the consumer at its
    batch's place, so failures come in the unwrapped loader's order."""

    _SENTINEL = object()

    def __init__(self, loader: Iterable, size: int = 2, keys=None,
                 device: str | torch.device = "cuda"):
        if size < 1:
            raise ValueError("prefetch size must be >= 1")
        self.loader = loader
        self.size = size
        self.keys = None if keys is None else frozenset(keys)
        self.device = resolve_device(device)

    def __len__(self):
        return len(self.loader)

    def __iter__(self) -> Iterator:
        dev = self.device
        cuda = dev.type == "cuda"
        side = torch.cuda.Stream(dev) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=self.size)
        stop = threading.Event()

        def _put(item) -> bool:
            """A bounded put that sees the consumer leave (``stop``)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in self.loader:
                    if stop.is_set():
                        return
                    if cuda:
                        with torch.cuda.device(dev), torch.cuda.stream(side):
                            item = to_device(item, self.keys, dev)
                            done = torch.cuda.Event()
                            done.record(side)
                    else:
                        item, done = to_device(item, self.keys, dev), None
                    if not _put((item, done)):
                        return
            except BaseException as e:  # noqa: BLE001 - raised in the consumer
                _put(e)
                return
            _put(self._SENTINEL)

        th = threading.Thread(target=produce, daemon=True)
        th.start()
        try:
            while True:
                got = q.get()
                if got is self._SENTINEL:
                    break
                if isinstance(got, BaseException):
                    raise got
                item, done = got
                if cuda:
                    consumer = torch.cuda.current_stream(dev)
                    consumer.wait_event(done)
                    for t in _tensors(item):
                        if t.device.type == "cuda":
                            t.record_stream(consumer)
                yield item
        finally:
            # stop the producer; it is a daemon, and stop bounds its extra
            # work to the batch in flight
            stop.set()
            th.join(timeout=5.0)
