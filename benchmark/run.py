"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration
(``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``loop`` picks the training
or the eval loop), its check limits (``benchmark/checks/<workload>.json``)
and its metrics, each read by ``benchmark/metrics/<metric>.py``. With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled stretch of the window.

Set-up (``setup_s``) runs from this process's start to the window's start.
After the window, the peak memory is read, the program's state is freed
and the plain reference (``benchmark/reference/``) recomputes what the
timed path produced; each number compared is printed with its limit on
standard error's last lines and under ``checks`` in the result, the last
line of standard output. Without a CUDA card, or with fewer than the cell
asks for, the run exits non-zero and prints no result.

A cell with ``chips`` above 1 runs one process a card
(``harness/ranks.py``), joined in one process group over NCCL; this
process builds the kernels first, then waits for the ranks. Rank 0's
window and check make the result (``setup_s`` from this process's start to
rank 0's window start: ``time.perf_counter`` is the system's monotonic
clock, one for every process); the memory peak is the fullest card's.
Every rank, and this process, is checked for the JAX package's modules."""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))

from harness import common  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_runner(cell: dict, seed: int, device, group=None):
    """The cell's loop; ``group``: the process group of one process a card
    (training only)."""
    loop = cell["traffic"]["loop"]
    if loop == "train":
        from harness.train import TrainCell

        return TrainCell(cell, seed, device, group)
    if loop == "eval":
        from harness.eval import EvalCell

        if cell["chips"] != 1 or group is not None:
            raise ValueError("an eval cell runs on one card")
        return EvalCell(cell, seed, device)
    raise ValueError(f"unknown loop {loop!r}")


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each limited number beside its limit; correct iff every one is
    there, finite and within its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = dict(value=value, limit=limit)
    return ok, checks


def metric_context(runner, window: dict, setup_s: float):
    trace = window.get("trace")
    ctx = types.SimpleNamespace(
        cell=runner.cell, args=runner.args, window=window, trace=trace,
        setup_s=setup_s, chips=int(runner.cell["chips"]),
        superpixel=getattr(runner, "superpixel", False))
    t = runner.cell["traffic"]
    if t["loop"] == "eval":
        ctx.height, ctx.width = int(t["height"]), int(t["width"])
        ctx.channels = runner.channels
    return ctx


def read_metrics(entries: list, ctx) -> dict:
    out = {}
    for m in entries:
        value = common.load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = dict(value=float(value), unit=m["unit"])
    return out


def summarize(runner, window: dict, setup_s: float, device,
              memory_peak: int) -> dict:
    """The result line but the check: metrics, device, breakdown."""
    import torch

    cell = runner.cell
    trace = window.get("trace")
    ctx = metric_context(runner, window, setup_s)
    metrics = read_metrics(cell["per_layer"] if trace is not None
                           else cell["end_to_end"], ctx)
    cuda = torch.device(device).type == "cuda"
    device_info = dict(platform="gpu" if cuda else "cpu",
                       kind=(torch.cuda.get_device_name(device) if cuda
                             else "cpu"),
                       count=cell["chips"], memory_peak_bytes=memory_peak)
    result = dict(correct=False, attempted=runner.attempted(window),
                  failed=0, metrics=metrics, device=device_info)
    if trace is not None:
        idle = window["idle_trace"]
        device_info.update(busy_s=idle.busy_s, window_s=idle.window_s)
        result["breakdown"] = dict(device_ops=trace.top_device_ops(10),
                                   idle_gaps=idle.idle_gaps(10))
    return result


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t0: float, group=None) -> dict:
    """Set-up, window, metrics and check of one run on one device; the
    result line. With ``group``, this rank's part of a run on one process
    a card: the check is rank 0's."""
    import torch

    runner = make_runner(cell, seed, device, group)
    runner.setup()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    window = runner.window(seconds, trace)
    result = summarize(runner, window, setup_s, device,
                       int(torch.cuda.max_memory_allocated(device))
                       if cuda else 0)
    program = runner.program_records()
    runner.free()
    reference = runner.reference_records()
    if getattr(runner, "rank", 0) == 0:
        numbers = runner.compare(program, reference)
        result["correct"], result["checks"] = judge(numbers,
                                                    cell["checks"]["limits"])
        result["readings"] = numbers
    return result


def run_rank(rank: int, device, group, cell: dict, seed: int,
             seconds: float, trace: bool, t0: float) -> dict:
    """One rank's part of a run (``harness/ranks.py``'s target)."""
    return run_cell(cell, seed, seconds, trace, device, t0, group)


def run_ranks(cell: dict, seed: int, seconds: float, trace: bool, t0: float,
              device_type: str = "cuda", target=run_rank
              ) -> tuple[dict, list]:
    """A run on ``cell["chips"]`` processes, one a card: rank 0's result
    with the fullest card's memory peak, and each rank's forbidden
    modules."""
    from harness import ranks

    if device_type == "cuda":
        from videowalk_tpu_torch.ops import _build

        _build.build_all()
    results, found = ranks.spawn(int(cell["chips"]), target,
                                 (cell, seed, seconds, trace, t0),
                                 device_type)
    result = results[0]
    result["device"]["memory_peak_bytes"] = max(
        r["device"]["memory_peak_bytes"] for r in results)
    return result, found


def main(argv=None) -> int:
    a = parse(argv)
    cell = common.load_cell(a.workload)
    import torch

    if not torch.cuda.is_available():
        common.fail("torch.cuda.is_available() is false: this benchmark "
                    "measures the card and has no CPU fallback")
    if torch.cuda.device_count() < cell["chips"]:
        common.fail(f"{a.workload} needs {cell['chips']} cards; "
                    f"{torch.cuda.device_count()} visible")
    if cell["chips"] == 1:
        result = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                          _T0)
        found = {}
    else:
        result, by_rank = run_ranks(cell, a.seed, a.seconds, bool(a.trace),
                                    _T0)
        found = {f"rank {r}": f for r, f in enumerate(by_rank) if f}
    if common.forbidden_modules():
        found["this process"] = common.forbidden_modules()
    if found:
        common.fail(f"forbidden modules loaded: {found}")
    for name, value in result.pop("readings").items():
        print(f"reading {name} {value!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    result["checks"] = result.pop("checks")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
