"""Training meters: windowed smoothing and step logging (counterpart of
``videowalk_tpu/utils/meters.py``; reference ``code/utils/__init__.py:47-197``):
the same window semantics and log line fields (eta, meters, iteration time,
data time, max mem), with the card's peak memory from
``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque

import torch

from videowalk_tpu_torch.utils.profile import timed

_END = object()     # the end of ``log_every``'s iterable


class SmoothedValue:
    """A series of values: median and average over a window, and the
    global average."""

    def __init__(self, window_size: int = 20, fmt: str | None = None):
        if fmt is None:
            fmt = "{median:.4f} ({global_avg:.4f})"
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        if not d:
            return 0.0
        return d[(len(d) - 1) // 2]    # torch.median: the lower middle

    @property
    def avg(self):
        return sum(self.deque) / max(1, len(self.deque))

    @property
    def global_avg(self):
        return self.total / max(1, self.count)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value)


def _device_memory_mb() -> float | None:
    """Peak memory the card's caching allocator handed out, in MB; None
    without an initialized card (reading it must not start CUDA)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)


class MetricLogger:
    """Iterator wrapper printing eta, meters, time, data time and max mem
    every ``print_freq`` steps."""

    def __init__(self, delimiter: str = "\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{attr}'")

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def log_every(self, iterable, print_freq, header=None, total=None):
        """Yield ``iterable``'s items, logging every ``print_freq``. The
        data time is the ``data_wait`` span around the iterator's ``next``
        (``utils/profile.py``)."""
        i = 0
        header = header or ""
        total = total if total is not None else len(iterable)
        start_time = end = time.perf_counter()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        space_fmt = ":" + str(len(str(total))) + "d"
        items = iter(iterable)
        while True:
            with timed("data_wait") as wait:
                obj = next(items, _END)
            if obj is _END:
                break
            data_time.update(wait.seconds)
            yield obj
            iter_time.update(time.perf_counter() - end)
            if i % print_freq == 0:
                eta = str(datetime.timedelta(
                    seconds=int(iter_time.global_avg * (total - i))))
                parts = [header,
                         ("[{0" + space_fmt + "}/{1}]").format(i, total),
                         f"eta: {eta}", str(self), f"time: {iter_time}",
                         f"data: {data_time}"]
                mem = _device_memory_mb()
                if mem is not None:
                    parts.append(f"max mem: {mem:.0f}")
                print(self.delimiter.join(parts), flush=True)
            i += 1
            end = time.perf_counter()
        total_time = str(datetime.timedelta(seconds=int(time.perf_counter()
                                                        - start_time)))
        print(f"{header} Total time: {total_time}", flush=True)
