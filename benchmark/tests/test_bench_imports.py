"""What a run loads: the harness, every traffic mix, metric and
configuration reader, and the reference, in a fresh interpreter, leave no
module whose whole top-level name is ``jax``, ``jaxlib``, ``flax``,
``optax`` or ``videowalk_tpu`` (``videowalk_tpu_torch`` starts with the
last but is another name). The reference alone loads nothing of
``videowalk_tpu_torch`` either."""

import os
import subprocess
import sys

from harness import common

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

PRELUDE = f"""
import sys
sys.path[:0] = [{BENCH_DIR!r}, {ROOT!r}]
from harness.common import forbidden_modules
"""


def loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    return eval(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    found = loaded("""
import json, glob, os
import run
from harness import common, eval, flops, inputs, train, trace
from videowalk_tpu_torch.cli import test, train as cli_train
from videowalk_tpu_torch.ops import slic, _build
bench = json.load(open(os.path.join(run.common.ROOT, "BENCHMARK.json")))
for w in bench["workloads"]:
    common.load_cell(w["name"])
for m in bench["end_to_end"] + bench["per_layer"]:
    common.load_module("metrics", m["name"])
import reference.crw, reference.slic, reference.propagation
print(forbidden_modules())
""")
    assert found == []


def test_the_reference_loads_nothing_of_the_program():
    found = loaded("""
import reference.crw, reference.slic, reference.propagation
print(forbidden_modules()
      + sorted({m.split(".")[0] for m in sys.modules
                if m.split(".")[0] == "videowalk_tpu_torch"}))
""")
    assert found == []


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "videowalk_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert common.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "videowalk_tpu.core", sys)
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert common.forbidden_modules() == ["flax", "videowalk_tpu"]


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    """The guard in the process that prints: a forbidden module loaded by
    the time the window has closed ends the run without a result line."""
    import pytest
    import torch

    import run

    def run_cell(*a, **kw):
        monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
        return dict(correct=True, checks={}, readings={})

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", run_cell)
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "eval-davis-480p", "--seed", "1",
                  "--seconds", "1"])
    out = capsys.readouterr()
    assert exc.value.code != 0 and out.out == ""
    assert "jaxlib" in out.err
