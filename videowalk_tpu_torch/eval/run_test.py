"""Sweep of the eval over hyperparameters (counterpart of
``videowalk_tpu/eval/run_test.py``; reference ``code/eval/run_test.py``):
the grid (checkpoints x videoLen L x topk K x temperature T x radius R),
each combination through ``cli.test`` -> ``convert_davis`` ->
``davis_metrics``; a checkpoint directory gives its newest
``model_*.pth``. Each stage runs as a subprocess, or all in this process
under ``--in-process``; ``--sbatch`` writes one job script a combination and
submits it.

    python -m videowalk_tpu_torch.eval.run_test --checkpoints c1 [c2 ...] \\
        --filelist davis_vallist.txt --davis /path/DAVIS [--L 20] [--K 10]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import subprocess
import sys

PKG = "videowalk_tpu_torch"


def newest_model(path: str) -> str:
    """The newest ``model_*.pth`` in a checkpoint directory; a file path
    passes through."""
    if os.path.isdir(path):
        cands = [f for f in os.listdir(path)
                 if f.startswith("model_") and f.endswith(".pth")]
        cands.sort(key=lambda f: os.path.getmtime(os.path.join(path, f)))
        if not cands:
            raise FileNotFoundError(f"no model_*.pth in {path}")
        return os.path.join(path, cands[-1])
    return path


def run_one(ckpt: str, L: int, K: int, T: float, R: float, args) -> dict:
    """One combination; its record (``rc``, and ``jf_mean``, ``submitted``
    or the error)."""
    name = (os.path.basename(ckpt).replace(".pth", "")
            + f"_L{L}_K{K}_T{T}_R{R}")
    save_path = os.path.join(args.out_dir, name)
    masks_path = os.path.join(save_path, "converted")
    os.makedirs(save_path, exist_ok=True)

    cmds = [
        [sys.executable, "-m", f"{PKG}.cli.test",
         "--filelist", args.filelist,
         "--model-type", args.model_type,
         "--resume", ckpt,
         "--save-path", save_path,
         "--topk", str(K), "--videoLen", str(L),
         "--radius", str(R), "--temperature", str(T),
         "--cropSize", str(args.cropSize),
         "--workers", str(getattr(args, "workers", 4)),
         "--prop-backend", getattr(args, "prop_backend", "auto"),
         "--encode-dtype", getattr(args, "encode_dtype", "float32"),
         "--device", getattr(args, "device", "cuda")]
        + (["--data-parallel"] if getattr(args, "data_parallel", False)
           else []),
        [sys.executable, "-m", f"{PKG}.eval.convert_davis",
         "-i", save_path, "-o", masks_path, "-d", args.davis],
        [sys.executable, "-m", f"{PKG}.eval.davis_metrics",
         "--results", masks_path, "--davis", args.davis],
    ]
    if args.sbatch:
        script = os.path.join(save_path, "job.sh")
        with open(script, "w") as f:
            f.write("#!/bin/bash\nset -e\n")
            for c in cmds:
                f.write(" ".join(c) + "\n")
        # a sweep that submitted nothing must not read as one that ran
        try:
            sub = subprocess.run(["sbatch", script], capture_output=True,
                                 text=True)
        except FileNotFoundError as e:
            return {"name": name, "rc": 127, "error": f"sbatch not found: {e}"}
        if sub.returncode != 0:
            return {"name": name, "rc": sub.returncode,
                    "error": (sub.stderr or sub.stdout).strip()[-500:]}
        return {"name": name, "rc": 0, "submitted": True,
                "sbatch": sub.stdout.strip()}

    if getattr(args, "in_process", False):
        # one process for the whole sweep: the kernels are built and loaded
        # once; a failing combination is caught and recorded
        from videowalk_tpu_torch.cli.test import main as test_main
        from videowalk_tpu_torch.eval.convert_davis import convert_all
        from videowalk_tpu_torch.eval.davis_metrics import evaluate_davis
        from videowalk_tpu_torch.utils.arguments import test_args

        try:
            print(f"= {name} (in-process)", flush=True)
            test_main(test_args(cmds[0][3:]))
            convert_all(save_path, masks_path, args.davis)
            metrics = evaluate_davis(masks_path, args.davis)
            return {"name": name, "rc": 0,
                    "jf_mean": float(metrics["J&F-Mean"])}
        except SystemExit as e:
            return {"name": name, "rc": int(e.code or 1),
                    "error": f"in-process stage exited: {e}"}
        except Exception as e:
            return {"name": name, "rc": 1,
                    "error": f"{type(e).__name__}: {e}"}

    jf = None
    for c in cmds:
        print("+", " ".join(c), flush=True)
        is_metrics = f"{PKG}.eval.davis_metrics" in c
        # the metrics' stdout is captured (and echoed) for the summary's J&F
        r = subprocess.run(c, capture_output=is_metrics, text=True)
        if is_metrics and r.stdout:
            print(r.stdout, end="", flush=True)
        if r.returncode != 0:
            if is_metrics and r.stderr:
                print(r.stderr, end="", file=sys.stderr, flush=True)
            return {"name": name, "rc": r.returncode,
                    "failed_cmd": " ".join(c)}
        if is_metrics:
            m = re.search(r"'J&F-Mean': ([0-9.]+)", r.stdout)
            jf = float(m.group(1)) if m else None
    return {"name": name, "rc": 0, "jf_mean": jf}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoints", nargs="+", required=True,
                        help="checkpoint files or dirs (newest model_* used)")
    parser.add_argument("--filelist", required=True)
    parser.add_argument("--davis", required=True, help="DAVIS dataset root")
    parser.add_argument("--model-type", default="scratch")
    parser.add_argument("--out-dir", default="./sweep_results")
    parser.add_argument("--cropSize", default=-1, type=int)
    parser.add_argument("--L", nargs="+", type=int, default=[20])
    parser.add_argument("--K", nargs="+", type=int, default=[10])
    parser.add_argument("--T", nargs="+", type=float, default=[0.05])
    parser.add_argument("--R", nargs="+", type=float, default=[12.0])
    parser.add_argument("--sbatch", action="store_true")
    parser.add_argument("--in-process", dest="in_process",
                        action="store_true",
                        help="run every combination's stages as calls in "
                             "this process")
    # forwarded to every eval run
    parser.add_argument("--workers", default=4, type=int,
                        help="threaded frame decode inside each video")
    parser.add_argument("--prop-backend", default="auto",
                        choices=["auto", "sparse"])
    parser.add_argument("--encode-dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--data-parallel", dest="data_parallel",
                        action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) | cuda:N | cpu")
    args = parser.parse_args(argv)

    ckpts = [newest_model(c) for c in args.checkpoints]
    results = [run_one(ckpt, L, K, T, R, args)
               for ckpt, L, K, T, R in itertools.product(
                   ckpts, args.L, args.K, args.T, args.R)]

    print("\n== sweep summary ==")
    for r in results:
        print(json.dumps(r), flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "sweep_summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    failed = [r["name"] for r in results if r.get("rc", 1) != 0]
    if failed:
        sys.exit(f"sweep: {len(failed)}/{len(results)} combos failed: "
                 f"{failed}")


if __name__ == "__main__":
    main()
