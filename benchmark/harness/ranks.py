"""One process a card, for a cell whose ``chips`` is above 1.

``spawn(world, target, args)`` starts ``world`` processes (the ``spawn``
start method: each a fresh interpreter). Each forms one process group with
the others over ``tcp://localhost:<a free port>`` through the program's
own ``parallel/multihost.py::initialize_distributed`` (NCCL, rank ``r`` on
``cuda:r``; gloo on the CPU), runs ``target(rank, device, group, *args)``
with its standard output sent to standard error, and leaves the group.
Each then reports what ``target`` returned or the error it raised, and
the forbidden modules (``common.forbidden_modules``) loaded by then.

The parent reads every report before it joins a process. Where a rank
fails, or ends without a report, it ends the others (they would wait in a
collective) and raises; it waits until every process has ended."""

from __future__ import annotations

import contextlib
import multiprocessing
import queue
import socket
import sys
import traceback

from harness import common

JOIN_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, device_type: str, reports,
          target, args) -> None:
    report = dict(rank=rank, value=None, error=None)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            import torch.distributed as dist
            from videowalk_tpu_torch.parallel import (initialize_distributed,
                                                      shutdown)

            device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
            initialize_distributed(f"localhost:{port}", world, rank,
                                   device=device)
            try:
                report["value"] = target(rank, device, dist.group.WORLD,
                                         *args)
            finally:
                shutdown()
    except Exception:
        report["error"] = traceback.format_exc()
    report["found"] = common.forbidden_modules()
    reports.put(report)


def spawn(world: int, target, args: tuple, device_type: str = "cuda"
          ) -> tuple[list, list]:
    """``target``'s return value on each rank and each rank's forbidden
    modules, both in rank order."""
    ctx = multiprocessing.get_context("spawn")
    reports = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank, daemon=True,
                         args=(r, world, port, device_type, reports, target,
                               args))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    try:
        while len(got) < world:
            try:
                report = reports.get(timeout=1.0)
            except queue.Empty:
                ended = [r for r, p in enumerate(procs)
                         if p.exitcode is not None and r not in got]
                if ended:
                    raise RuntimeError(
                        f"rank {ended[0]} ended (exit code "
                        f"{procs[ended[0]].exitcode}) without a report")
                continue
            got[report["rank"]] = report
            if report["error"] is not None:
                raise RuntimeError(f"rank {report['rank']} failed:\n"
                                   f"{report['error']}")
    finally:
        if len(got) < world or any(r["error"] for r in got.values()):
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"rank {bad[0]} exited with code "
                           f"{procs[bad[0]].exitcode}")
    return ([got[r]["value"] for r in range(world)],
            [got[r]["found"] for r in range(world)])
