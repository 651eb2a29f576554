"""Readings that the check's limits are set from (run on the card, not by
the benchmark's own runs):

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ... \\
        [--controls 3] [--seconds 4] [--out readings.jsonl]

For each seed, the program's numbers as a run's check computes them
(training: the recorded first steps, no window; eval: a short window);
for the first ``--controls`` seeds also the control's (the reference put
in the program's place one precision below the configuration's: fp8
trunk convolutions and bf16 SLIC features for training, TF32 for eval)
and, for training, the fault of half the batch left out, and on more than
one card the fault of the exchange left out (``exchange_left_out``). A
cell on more than one card runs one process a card, as a run does
(``harness/ranks.py``); rank 0 writes. One JSON line each."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))

import run  # noqa: E402
from harness import common  # noqa: E402


def worst_leaves(program: dict, ref: dict, n: int = 4) -> dict:
    """The leaves with the largest gradient, whole-gradient and change
    gaps: name, gap, the reference's norm and the median leaf's norm."""
    import statistics

    from harness.train import vector_gaps

    out = {}
    for key in ("grad", "grad_vec", "change"):
        r = ref["grad" if key == "grad_vec" else key]
        med = statistics.median(r.values())
        if key == "grad_vec":
            g = vector_gaps(program["grad1"], ref["grad1"], r)
        else:
            g = {k: abs(program[key][k] - r[k]) / max(r[k], med) for k in r}
        gaps = sorted(((g[k], k, r[k]) for k in r), reverse=True)[:n]
        out[key + "_worst"] = [[k, v, norm, med] for v, k, norm in gaps]
    return out


@contextlib.contextmanager
def exchange_left_out():
    """The program's train state built without its process group: each
    rank steps its own row block with rank-local BN moments and no
    gradient average (the harness's own group still times the ranks)."""
    import videowalk_tpu_torch.parallel as parallel

    original = parallel.create_train_state

    def alone(*args, group=None, **kwargs):
        return original(*args, **kwargs)

    parallel.create_train_state = alone
    try:
        yield
    finally:
        parallel.create_train_state = original


def program_records(cell: dict, seed: int, device, group, seconds: float,
                    train: bool):
    d = run.make_runner(cell, seed, device, group)
    d.setup()
    if not train:
        d.window(seconds, False)
    program = d.program_records()
    d.free()
    return d, program


def calibrate(rank: int, device, group, cell: dict, seeds: list,
              controls: int, seconds: float, out: str) -> int:
    """Every seed's readings; rank 0 prints and writes them."""
    import torch

    train = cell["traffic"]["loop"] == "train"
    cuda = torch.device(device).type == "cuda"
    sink = open(out, "a") if out and rank == 0 else None
    try:
        for i, seed in enumerate(seeds):
            t0 = time.perf_counter()
            d, program = program_records(cell, seed, device, group, seconds,
                                         train)
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            ref = d.reference_records()
            rows = [("program", program)]
            if cuda and rank == 0:
                print(f"reference peak "
                      f"{torch.cuda.max_memory_allocated(device)} bytes",
                      file=sys.stderr, flush=True)
            if i < controls:
                if train:
                    rows.append(("control", d.reference_records("fp8")))
                    rows.append(("half_batch", d.reference_records(
                        "f32", fault="half_batch")))
                    if group is not None:
                        with exchange_left_out():
                            rows.append(("exchange_left_out", program_records(
                                cell, seed, device, group, seconds,
                                train)[1]))
                else:
                    rows.append(("control", d.reference_records("tf32")))
            for kind, records in rows:
                numbers = d.compare(records, ref)
                if train and kind == "program":
                    numbers.update(worst_leaves(records, ref))
                line = json.dumps(dict(
                    workload=cell["name"], seed=seed, kind=kind,
                    seconds=time.perf_counter() - t0, **numbers))
                if rank == 0:
                    print(line, flush=True)
                    if sink:
                        sink.write(line + "\n")
                        sink.flush()
            del d
            if cuda:
                torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        common.fail("no CUDA card")
    cell = common.load_cell(a.workload)
    args = (cell, a.seeds, a.controls, a.seconds, a.out)
    if cell["chips"] == 1:
        return calibrate(0, "cuda", None, *args)
    from harness import ranks
    from videowalk_tpu_torch.ops import _build

    _build.build_all()
    ranks.spawn(int(cell["chips"]), calibrate, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
