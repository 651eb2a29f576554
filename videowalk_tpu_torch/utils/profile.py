"""Spans of the program's layers, and ``--profile-dir``'s trace.

A span names one stretch of the program's work: the train step
(``step``) and its layers (``trunk``, ``nodes``, ``walk``, ``optimizer``,
with ``sp_pool`` inside ``nodes``, and ``trunk.backward``,
``nodes.backward``, ``walk.backward``), ``slic``, the data-parallel
all-reduces (``dp.all_reduce``), the train loop's host work (``data_wait``,
``augs``, ``fetch``, ``checkpoint``) and the eval's phases (``video``:
``encode``, ``pca_vis``, ``labels``, ``propagate``, ``dump``).

- ``span(name, root=False, **counts)``: a context manager. ``root`` marks
  the span of one unit of work (a train step, a video): a span opened on a
  thread with no open span of its own takes the innermost open root as its
  parent. ``timed(...)`` is the same for a site whose caller
  reads the host seconds (``.seconds``) whether spans are on or not;
  ``begin``/``end`` a pair for autograd hooks; ``backward_span`` a span over
  a layer's backward pass; ``spanned(name)`` a function decorator;
  ``count(**counts)`` adds counts to the innermost open span (the trunk's
  BN sites count ``bn_fused`` and ``bn_plain``, ``ops/bn_act.py``).
- Off, the default, a site reads the two flags below and returns a shared
  null context: no ``record_function`` call, no CUDA event, no hook, no
  record. Spans are on while a ``torch.profiler`` session records, or
  after ``enable()``.
- An on span records a ``record_function`` range (so a Chrome trace shows
  it on the kernels' clock), host start and end (``perf_counter_ns``), a
  start and end CUDA event on the current stream where CUDA is in use, its
  parent (the innermost open span of its thread, else the open root: a
  backward span runs on autograd's thread) and its counts.
- Records stay in memory, aggregated by name; their CUDA events are
  resolved when read (past a bound, those already complete are folded on
  the way), so memory stays bounded however long spans are on.
  ``summary()`` (after the caller's synchronize) returns ``{name: {n,
  parents, host_ms, device_ms, self_host_ms, self_device_ms, counts}}``,
  self time being the span less what its children cover; ``reset()``
  clears it.

``Trace``: ``--profile-dir`` of both CLIs, a ``torch.profiler`` trace (host
activity, and the card's kernels where it runs on one) written into a
directory as a Chrome trace (counterpart of the JAX CLIs'
``jax.profiler.start_trace`` / ``stop_trace``), with the spans' table
printed when it stops."""

from __future__ import annotations

import functools
import os
import threading
import time

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

# spans on without a profiler session (enable() / disable())
_enabled = False
# closed records waiting to be folded into the aggregates; folded past
# this many without waiting for the card
_FOLD_AT = 1024

_lock = threading.Lock()
_local = threading.local()
_roots: list = []        # open root spans, innermost last
_closed: list = []
_agg: dict = {}


def enable() -> None:
    """Turn spans on outside any profiler session."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def on() -> bool:
    return _enabled or _profiler._is_profiler_enabled


class _Record:
    __slots__ = ("name", "parent", "counts", "t0", "t1", "events", "rf",
                 "stack", "child_host_ns", "child_device_ms", "device_ms")

    def __init__(self, name, parent, counts, t0):
        self.name, self.parent = name, parent
        self.counts, self.t0, self.t1 = counts, t0, None
        self.events = self.rf = self.stack = self.device_ms = None
        self.child_host_ns, self.child_device_ms = 0, 0.0


class _Agg:
    __slots__ = ("n", "parents", "host_ns", "self_host_ns", "device_ms",
                 "self_device_ms", "timed", "counts")

    def __init__(self):
        self.n = self.host_ns = self.self_host_ns = 0
        self.parents: set = set()
        self.device_ms = self.self_device_ms = 0.0
        self.timed = False
        self.counts: dict = {}


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _open(name: str, root: bool, counts: dict, t0: int) -> _Record:
    stack = _stack()
    parent = stack[-1] if stack else (_roots[-1] if _roots else None)
    rec = _Record(name, parent, counts, t0)
    if root:
        _roots.append(rec)
    rec.rf = record_function(name)
    rec.rf.__enter__()
    if torch.cuda.is_initialized():
        rec.events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        rec.events[0].record()
    stack.append(rec)
    rec.stack = stack
    return rec


def _close(rec: _Record, t1: int) -> None:
    if rec.events is not None:
        rec.events[1].record()
    rec.rf.__exit__(None, None, None)
    rec.t1 = t1
    stack, rec.stack, rec.rf = rec.stack, None, None
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is rec:
            del stack[i]
            break
    if rec in _roots:
        _roots.remove(rec)
    if rec.parent is not None:
        rec.parent.child_host_ns += t1 - rec.t0
    _closed.append(rec)
    if len(_closed) > _FOLD_AT:
        _fold(wait=False)


def _fold(wait: bool) -> None:
    """Fold closed records, in the order they closed (children before their
    parents), into the aggregates; without ``wait``, stop at the first
    whose end event the card has not reached."""
    with _lock:
        done = 0
        for rec in _closed:
            if rec.events is not None:
                start, stop = rec.events
                if wait:
                    stop.synchronize()
                elif not stop.query():
                    break
                rec.device_ms = start.elapsed_time(stop)
                rec.events = None
            a = _agg.get(rec.name)
            if a is None:
                a = _agg[rec.name] = _Agg()
            host = rec.t1 - rec.t0
            a.n += 1
            if rec.parent is not None:
                a.parents.add(rec.parent.name)
            a.host_ns += host
            a.self_host_ns += host - rec.child_host_ns
            if rec.device_ms is not None:
                a.timed = True
                a.device_ms += rec.device_ms
                a.self_device_ms += rec.device_ms - rec.child_device_ms
                if rec.parent is not None:
                    rec.parent.child_device_ms += rec.device_ms
            for k, v in rec.counts.items():
                a.counts[k] = a.counts.get(k, 0) + v
            done += 1
        del _closed[:done]


def summary() -> dict:
    """``{name: {n, parents, host_ms, device_ms, self_host_ms,
    self_device_ms, counts}}`` of every span closed since the last
    ``reset()``, in the order each name first closed: its ``n`` records'
    times and counts summed, and the names of their parent spans
    (``parents``, sorted; empty for a span opened outside any other).
    Device times are None where no record of the name had CUDA events.
    Waits for the events of the spans not yet read."""
    _fold(wait=True)
    return {name: dict(n=a.n, parents=sorted(a.parents),
                       host_ms=a.host_ns / 1e6,
                       device_ms=a.device_ms if a.timed else None,
                       self_host_ms=a.self_host_ns / 1e6,
                       self_device_ms=a.self_device_ms if a.timed else None,
                       counts=dict(a.counts))
            for name, a in _agg.items()}


def reset() -> None:
    with _lock:
        _closed.clear()
        _agg.clear()


class _Null:
    """The shared context of a span site while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts) -> None:
        pass


_NULL = _Null()


class _Span:
    """An on span (``span``), or a host clock that is also a span while
    spans are on (``timed``)."""

    __slots__ = ("name", "root", "counts", "rec", "t0", "seconds")

    def __init__(self, name: str, root: bool, counts: dict):
        self.name, self.root, self.counts = name, root, counts
        self.rec, self.seconds = None, None

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        if on():
            self.rec = _open(self.name, self.root, self.counts, self.t0)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.seconds = (t1 - self.t0) / 1e9
        if self.rec is not None:
            _close(self.rec, t1)
        return False

    def add(self, **counts) -> None:
        """Counts known only inside the span."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v


def span(name: str, root: bool = False, **counts):
    """A span of ``name`` over the ``with`` block (the shared null context
    while spans are off)."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, root, counts)


def timed(name: str, root: bool = False, **counts) -> _Span:
    """``span``, for a site that reads its host seconds (``.seconds``,
    the span's own host clock) whether spans are on or not."""
    return _Span(name, root, counts)


def begin(name: str, root: bool = False, **counts) -> _Record | None:
    """Open a span that ``end`` closes (on the thread that opened it);
    None while spans are off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return None
    return _open(name, root, counts, time.perf_counter_ns())


def end(rec: _Record | None) -> None:
    if rec is not None:
        _close(rec, time.perf_counter_ns())


def count(**counts) -> None:
    """Add ``counts`` to the innermost open span of this thread (else the
    open root); nothing while spans are off or no span is open."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    stack = _stack()
    rec = stack[-1] if stack else (_roots[-1] if _roots else None)
    if rec is not None:
        for k, v in counts.items():
            rec.counts[k] = rec.counts.get(k, 0) + v


def spanned(name: str):
    """Decorator: each call of the function runs in a span of ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not (_enabled or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name, False, {}):
                return fn(*args, **kwargs)
        return inner
    return wrap


def backward_span(name: str, output: torch.Tensor, *inputs) -> None:
    """A span of ``name`` over the backward pass of the layer that made
    ``output`` from ``inputs`` (tensors, or modules standing for their
    parameters): it opens when ``output``'s gradient has arrived (a
    pre-hook of its grad node, which runs after the tensor hooks that
    close the layer before) and closes when the gradient of the last input
    or parameter that needs one is done. Registers its hooks only while
    spans are on and ``output`` is part of a graph; the hooks on parameters
    remove themselves when they fire."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    if output.grad_fn is None or not torch.is_grad_enabled():
        return
    needed = []
    for x in inputs:
        for t in (x.parameters() if isinstance(x, torch.nn.Module)
                  else (x,)):
            if t.requires_grad:
                needed.append(t)
    if not needed:
        return
    box = []

    def opened(grad_outputs):
        box.append(begin(name))

    def done(grads):
        handle.remove()
        while box:
            end(box.pop())

    output.grad_fn.register_prehook(opened)
    handle = torch.autograd.graph.register_multi_grad_hook(needed, done)


def format_table(stats: dict) -> list[str]:
    """One line a span name: count, then host and device ms as total,
    mean a call and self total (device "-" where no CUDA events), the
    parent spans (``in``, "-" for none) and the counts' totals."""
    def ms(total, n, self_total):
        if total is None:
            return "-"
        return f"{total:.3f} (mean {total / n:.3f}, self {self_total:.3f})"

    width = max((len(k) for k in stats), default=4)
    lines = []
    for name, s in stats.items():
        line = (f"span {name:<{width}}  n {s['n']:>6}  host ms "
                f"{ms(s['host_ms'], s['n'], s['self_host_ms'])}  device ms "
                f"{ms(s['device_ms'], s['n'], s['self_device_ms'])}  in "
                f"{','.join(s['parents']) or '-'}")
        lines.append(" ".join([line] + [f"{k} {v}" for k, v
                                        in s["counts"].items()]))
    return lines


class Trace:
    """One trace, started and stopped once: ``start()`` before the traced
    work, ``stop()`` after it (idempotent, so callers also call it on every
    exit path) writes ``<directory>/<name>.pt.trace.json`` and prints the
    table of the spans recorded since ``start()``."""

    def __init__(self, directory: str, name: str, device: torch.device):
        self.directory, self.name, self.device = directory, name, device
        self.path: str | None = None
        self._prof = None

    def start(self) -> None:
        if self._prof is not None or self.path is not None:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        reset()
        prof.start()
        self._prof = prof

    def stop(self) -> str | None:
        """Stop and write the trace; returns its path (None if it never
        started)."""
        prof, self._prof = self._prof, None
        if prof is None:
            return self.path
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory,
                                 f"{self.name}.pt.trace.json")
        prof.export_chrome_trace(self.path)
        print(f"profiler trace written to {self.path}", flush=True)
        for line in format_table(summary()):
            print(line, flush=True)
        return self.path
