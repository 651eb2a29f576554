"""The port's eval modules need neither jax nor the JAX package: in a
subprocess where importing ``jax`` or ``videowalk_tpu`` fails, every module
of the eval tail imports, and ``python -m
videowalk_tpu_torch.eval.davis_metrics`` scores a synthetic DAVIS tree
without loading torch (so no CUDA runtime and no kernel library) and
without any ``videowalk_tpu.`` module."""

import json
import os
import subprocess
import sys

from _synth import make_davis_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ("eval.davis_metrics", "eval.convert_davis",
           "eval.make_davis_vallist", "eval.eval_pck", "eval.eval_vip",
           "eval.test_utils", "eval.run_test", "data.jhmdb", "data.vos",
           "utils.visualize", "cli.test")

PROGRAM = """
import json, runpy, sys
sys.modules["jax"] = None
sys.modules["videowalk_tpu"] = None
sys.argv = ["davis_metrics", "--results", {results!r}, "--davis", {davis!r}]
runpy.run_module("videowalk_tpu_torch.eval.davis_metrics", run_name="__main__")
loaded = sorted(sys.modules)
import importlib
for m in {modules!r}:
    importlib.import_module("videowalk_tpu_torch." + m)
print(json.dumps(dict(
    after_metrics=loaded,
    jax=[m for m in sys.modules if (m == "jax" or m.startswith("jax."))
         and sys.modules[m] is not None],
    reference=[m for m in sys.modules if m.startswith("videowalk_tpu.")])))
"""


def test_eval_tail_runs_without_jax(tmp_path):
    from PIL import Image

    davis = make_davis_tree(str(tmp_path / "DAVIS"), vids=("v",), hw=32,
                            frames=4)
    ann = os.path.join(davis, "Annotations", "480p", "v")
    res = tmp_path / "res" / "v"
    res.mkdir(parents=True)
    for f in os.listdir(ann):           # the ground truth as the prediction
        Image.open(os.path.join(ann, f)).save(res / f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", PROGRAM.format(
            results=str(tmp_path / "res"), davis=davis, modules=MODULES)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert "'J&F-Mean': 1.0" in out.stdout
    got = json.loads(lines[-1])
    assert "torch" not in got["after_metrics"]
    assert not any(m.startswith("videowalk_tpu_torch.ops")
                   for m in got["after_metrics"])
    assert got["jax"] == [] and got["reference"] == []
