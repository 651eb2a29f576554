"""``BENCHMARK.json`` and the files it names: the contract's shape, names
and units, every file found by name, every per-layer metric reported
where its end-to-end metric is; and ``run.py`` refusing to run without a
card, with no fallback to the CPU."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

from harness import common

BENCH = common.read_json(os.path.join(common.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_shape():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(common.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and k != "source" or group == "configs" and k == \
                        "source":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for metric_group in (True, False):
        group = [n for g, n in names if g == metric_group]
        assert len(group) == len(set(group))
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in BENCH[group]]
        assert len(ns) == len(set(ns))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = common.load_cell(cell)
    assert c["config"]["name"] == c["config_name"]
    assert c["traffic"]["loop"] in ("train", "eval")
    assert c["checks"]["limits"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(common.load_module("metrics", m["name"]).read)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e


def test_config_files():
    for c in BENCH["configs"]:
        path = os.path.join(common.ROOT, c["file"])
        assert c["file"].startswith("benchmark/")
        cfg = common.read_json(path)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(cfg["assumed"])


def test_per_layer_workloads_report_what_they_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"


def test_four_chip_cells_and_budget():
    cells = BENCH["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def run_py(args, cwd, env=None):
    full = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    full.update(env or {})
    return subprocess.run(
        [sys.executable, "benchmark/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300, env=full)


def test_no_card_no_result():
    out = run_py(["--workload", "train-patch-b32", "--seed", str(2 ** 33),
                  "--seconds", "1", "--trace", "0"], common.ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "cuda" in out.stderr.lower()


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(["--workload", "eval-davis-480p", "--seed", "3",
                  "--seconds", "1", "--trace", "0"], tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.cuda
def test_one_short_run_on_the_card(card):
    out = run_py(["--workload", "train-patch-b32", "--seed", str(2 ** 31 + 9),
                  "--seconds", "2", "--trace", "0"], common.ROOT,
                 env={"CUDA_VISIBLE_DEVICES": os.environ.get(
                     "CUDA_VISIBLE_DEVICES", "0")})
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    assert math.isfinite(line["metrics"]["train_clips_per_s"]["value"])


@pytest.mark.parametrize("twin,original", [
    ("dp_clips_per_s", "train_clips_per_s"),
    ("mfu.dp", "mfu.train"), ("device_idle.dp", "device_idle.train")])
def test_four_card_twins_read_as_the_one_card_metrics(twin, original):
    """A four-card cell's own names (its runs spread wider, so its rate
    has a bound of its own) read what the one-card metrics read."""
    import types

    trace = types.SimpleNamespace(window_s=2.0, busy_s=1.9)
    ctx = types.SimpleNamespace(
        args=types.SimpleNamespace(img_size=256, patch_size=[64, 64, 3],
                                   clip_len=8, model_type="scratch",
                                   remove_layers=[]),
        superpixel=False, chips=4,
        window=dict(clips=12800, wall_s=24.0, periods_ms=[240.0, 250.5,
                                                          241.0, 239.5],
                    idle_trace=trace))
    value = common.load_module("metrics", twin).read(ctx)
    assert value is not None
    assert value == common.load_module("metrics", original).read(ctx)
