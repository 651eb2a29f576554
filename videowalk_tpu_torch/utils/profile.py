"""``--profile-dir`` of both CLIs: a ``torch.profiler`` trace (host
activity, and the card's kernels where it runs on one) written into a
directory as a Chrome trace (counterpart of the JAX CLIs'
``jax.profiler.start_trace`` / ``stop_trace``)."""

from __future__ import annotations

import os

import torch


class Trace:
    """One trace, started and stopped once: ``start()`` before the traced
    work, ``stop()`` after it (idempotent, so callers also call it on every
    exit path) writes ``<directory>/<name>.pt.trace.json``."""

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
        return self.path
