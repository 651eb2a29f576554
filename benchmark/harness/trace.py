"""The traced stretch: ``torch.profiler`` (CPU and CUDA activity) around a
short piece of the window, exported as a Chrome trace to a temporary file,
read back and deleted. ``Trace`` holds what the per-layer metrics read:
the device's operations, the host's launch calls and operators, and the
benchmark's own spans (``record_function`` ranges named ``bench.*``)."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")


@contextlib.contextmanager
def profiled(device, out: dict, spans: dict | None = None, cpu: bool = True):
    """Profile the block; on exit ``out["trace"]`` is its ``Trace`` and
    ``out["wall_s"]`` the host seconds from the synchronize before it to
    the trace read back. ``spans`` maps ``(module, function name)`` to a
    span name: each call of that function inside the block runs in a
    ``record_function`` range of that name (put back on exit). ``cpu``:
    also record the host's operators (their recording slows the host, so
    a stretch that measures the device's idle share leaves it off)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    patched = []
    for (module, attr), name in (spans or {}).items():
        orig = getattr(module, attr)

        def wrapper(*a, _orig=orig, _name=name, **kw):
            with record_function(_name):
                return _orig(*a, **kw)

        setattr(module, attr, wrapper)
        patched.append((module, attr, orig))
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    prof = profile(activities=([ProfilerActivity.CPU] if cpu else [])
                   + [ProfilerActivity.CUDA])
    prof.start()
    try:
        yield
        torch.cuda.synchronize(device)
    finally:
        prof.stop()
        for module, attr, orig in patched:
            setattr(module, attr, orig)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                out["trace"] = Trace(json.load(fh)["traceEvents"])
        finally:
            os.unlink(path)
        out["wall_s"] = time.perf_counter() - t0


class Trace:
    """Complete (``ph == "X"``) events of one Chrome trace, in µs."""

    def __init__(self, events: list):
        ev = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in ev if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in ev if e.get("cat") == "kernel"]
        self.launches = [e for e in ev
                         if e.get("cat") in ("cuda_runtime", "cuda_driver")
                         and e.get("name") in LAUNCH_CALLS]
        self.cpu_ops = [e for e in ev if e.get("cat") == "cpu_op"]
        self.runtime = [e for e in ev
                        if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        self.spans = [e for e in ev if e.get("cat") == "user_annotation"
                      and str(e.get("name", "")).startswith("bench.")]
        starts = [e["ts"] for e in ev]
        ends = [e["ts"] + e["dur"] for e in ev]
        self.t0, self.t1 = (min(starts), max(ends)) if ev else (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device's operation intervals, merged."""
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(e["dur"] for e in self.kernels if match(e["name"])) * 1e-6

    def kernel_s_in_spans(self, prefix: str) -> float:
        """Device seconds of the kernels launched inside the benchmark's
        spans whose name starts with ``prefix`` (launch and kernel matched
        by their correlation id)."""
        spans = [(s["ts"], s["ts"] + s["dur"]) for s in self.spans
                 if s["name"].startswith(prefix)]
        corr = {e.get("args", {}).get("correlation") for e in self.launches
                if any(a <= e["ts"] <= b for a, b in spans)}
        corr.discard(None)
        return sum(e["dur"] for e in self.kernels
                   if e.get("args", {}).get("correlation") in corr) * 1e-6

    def top_device_ops(self, n: int = 10) -> list:
        total: dict = {}
        for e in self.device:
            total[e["name"]] = total.get(e["name"], 0.0) + e["dur"] * 1e-6
        return [[k[:120], v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest device idle gaps inside the window, each named by
        the innermost host operator running at its middle (or, in a
        stretch without host operators, the runtime call there)."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            inside = [e for e in self.cpu_ops or self.runtime
                      if e["ts"] <= mid <= e["ts"] + e["dur"]]
            name = (min(inside, key=lambda e: e["dur"])["name"] if inside
                    else "host between operators" if self.cpu_ops
                    else "host between runtime calls")
            out.append([f"{name[:100]} @ {(a - self.t0) * 1e-3:.3f} ms",
                        (b - a) * 1e-6])
        return out
