"""Readings that the check's limits are set from (run on the card, not by
the benchmark's own runs):

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ... \\
        [--controls 3] [--seconds 4] [--out readings.jsonl]

For each seed, the program's numbers as a run's check computes them
(training: the recorded first steps, no window; eval: a short window);
for the first ``--controls`` seeds also the control's (the reference put
in the program's place one precision below the configuration's: fp8
trunk convolutions and bf16 SLIC features for training, TF32 for eval)
and, for training, the fault of half the batch left out. One JSON line
each."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))

from harness import common  # noqa: E402


def worst_leaves(program: dict, ref: dict, n: int = 4) -> dict:
    """The leaves with the largest gradient and change gaps: name, gap,
    the reference's norm and the median leaf's norm."""
    import statistics

    out = {}
    for key in ("grad", "change"):
        r, p = ref[key], program[key]
        med = statistics.median(r.values())
        gaps = sorted(((abs(p[k] - r[k]) / max(r[k], med), k, r[k])
                       for k in r), reverse=True)[:n]
        out[key + "_worst"] = [[k, g, v, med] for g, k, v in gaps]
    return out


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
    import run

    cell = common.load_cell(a.workload)
    train = cell["traffic"]["loop"] == "train"
    out = open(a.out, "a") if a.out else None
    for i, seed in enumerate(a.seeds):
        t0 = time.perf_counter()
        d = run.make_runner(cell, seed, "cuda")
        d.setup()
        if not train:
            d.window(a.seconds, False)
        program = d.program_records()
        d.free()
        torch.cuda.reset_peak_memory_stats()
        ref = d.reference_records()
        rows = [("program", d.compare(program, ref))]
        if train:
            rows[0][1].update(worst_leaves(program, ref))
        print(f"reference peak {torch.cuda.max_memory_allocated()} bytes",
              file=sys.stderr, flush=True)
        if i < a.controls:
            if train:
                rows.append(("control", d.compare(
                    d.reference_records("fp8"), ref)))
                rows.append(("half_batch", d.compare(
                    d.reference_records("f32", fault="half_batch"), ref)))
            else:
                rows.append(("control", d.compare(
                    d.reference_records("tf32"), ref)))
        for kind, numbers in rows:
            line = json.dumps(dict(workload=a.workload, seed=seed, kind=kind,
                                   seconds=time.perf_counter() - t0,
                                   **numbers))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del d
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
