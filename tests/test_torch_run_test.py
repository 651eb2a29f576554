"""The port's sweep runner (``videowalk_tpu_torch/eval/run_test.py``)
against the JAX runner's behaviour (``tests/test_run_test_sweep.py``):
``newest_model``, the ``--sbatch`` job script (the port's module names in
the three commands, the forwarded flags), and ``--in-process`` on a tiny
DAVIS tree, whose J&F equals the JAX runner's on the same ``.pth`` (every
converted mask equal; the eval slice agrees to atol 1e-4 on soft labels,
``tests/test_torch_eval.py``)."""

import json
import os
import subprocess
import time
import types

import pytest
import torch

from videowalk_tpu.eval import run_test as jrt

from videowalk_tpu_torch.eval import run_test as trt

from _synth import make_crw_checkpoint, make_davis_tree

torch.set_num_threads(1)


@pytest.mark.parametrize("mod", [trt, jrt], ids=["port", "jax"])
def test_newest_model(mod, tmp_path):
    d = tmp_path / "ckpts"
    d.mkdir()
    for i, name in enumerate(["model_0.pth", "model_3.pth", "model_1.pth",
                              "checkpoint.pth"]):
        p = d / name
        p.write_bytes(b"x")
        os.utime(p, (time.time() - 100 + i * 10,) * 2)
    assert mod.newest_model(str(d)).endswith("model_1.pth")
    f = tmp_path / "model_9.pth"
    f.write_bytes(b"x")
    assert mod.newest_model(str(f)) == str(f)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        mod.newest_model(str(tmp_path / "empty"))


def _sbatch_run(mod, tmp_path, monkeypatch, returncode=0):
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: calls.append(a)
                        or types.SimpleNamespace(
                            returncode=returncode,
                            stdout="Submitted batch job 1", stderr="denied"))
    ckpt = tmp_path / "model_5.pth"
    ckpt.write_bytes(b"x")
    args = types.SimpleNamespace(
        out_dir=str(tmp_path / mod.__name__), filelist="fl.txt",
        model_type="scratch", davis="/data/DAVIS", cropSize=-1, sbatch=True,
        data_parallel=True, encode_dtype="bfloat16")
    res = mod.run_one(str(ckpt), 20, 10, 0.05, 12.0, args)
    script = os.path.join(args.out_dir, "model_5_L20_K10_T0.05_R12.0",
                          "job.sh")
    return res, open(script).read().splitlines(), calls


def test_sbatch_job_names_the_ports_modules(tmp_path, monkeypatch):
    """The same job script as the JAX runner's, line for line, but with
    the port's package (and ``--device cuda``); submitted, or the
    failure recorded."""
    res, lines, calls = _sbatch_run(trt, tmp_path, monkeypatch)
    want_res, want, _ = _sbatch_run(jrt, tmp_path, monkeypatch)
    assert res == want_res and res["submitted"]
    assert calls[0][0][0] == "sbatch" and len(lines) == len(want) == 5
    assert lines[:2] == want[:2] == ["#!/bin/bash", "set -e"]
    port = [ln.replace(f"{trt.PKG}.", "videowalk_tpu.").replace(
        " --device cuda", "").replace(str(tmp_path / trt.__name__),
                                      str(tmp_path / jrt.__name__))
        for ln in lines]
    assert port == want
    for mod, ln in zip(("cli.test", "eval.convert_davis",
                        "eval.davis_metrics"), lines[2:]):
        assert f"-m videowalk_tpu_torch.{mod} " in ln
        assert "videowalk_tpu." not in ln
    assert "--data-parallel" in lines[2] and "bfloat16" in lines[2]
    (tmp_path / "x").mkdir()
    res, _, _ = _sbatch_run(trt, tmp_path / "x", monkeypatch, returncode=1)
    assert res["rc"] == 1 and res["error"] == "denied"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from videowalk_tpu_torch.eval.make_davis_vallist import make_list

    root = tmp_path_factory.mktemp("sweep")
    davis = make_davis_tree(str(root / "DAVIS"), vids=("video0",), hw=64,
                            frames=6)
    fl = root / "davis_vallist.txt"
    fl.write_text("\n".join(make_list(davis)) + "\n")
    ck = make_crw_checkpoint(str(root / "model_0.pth"), "scratch_zeropad",
                             seed=0)
    return davis, str(fl), ck


def test_in_process_sweep_matches_the_jax_runner(tree, tmp_path):
    """``--in-process`` over two topk values: the summary, the converted
    masks and the J&F of each combination equal the JAX runner's; a bogus
    DAVIS root makes a combination fail, recorded, and the sweep exit."""
    davis, fl, ck = tree
    argv = ["--checkpoints", ck, "--filelist", fl, "--davis", davis,
            "--model-type", "scratch_zeropad", "--L", "3", "--K", "3", "5",
            "--R", "6", "--in-process", "--workers", "0"]
    trt.main(argv + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"])
    jrt.main(argv + ["--out-dir", str(tmp_path / "jax")])
    got = json.load(open(tmp_path / "port" / "sweep_summary.json"))
    want = json.load(open(tmp_path / "jax" / "sweep_summary.json"))
    assert got == want
    assert [r["rc"] for r in got] == [0, 0]
    assert all(0.0 < r["jf_mean"] <= 1.0 for r in got)
    for r in got:
        for t in ("port", "jax"):
            assert os.path.exists(tmp_path / t / r["name"] / "converted" /
                                  "video0" / "00000.png")

    with pytest.raises(SystemExit):
        trt.main(["--checkpoints", ck, "--filelist", fl,
                  "--davis", str(tmp_path / "nope"),
                  "--model-type", "scratch_zeropad", "--L", "3", "--K", "3",
                  "--R", "6", "--in-process", "--workers", "0",
                  "--out-dir", str(tmp_path / "bad"), "--device", "cpu"])
    rec = json.load(open(tmp_path / "bad" / "sweep_summary.json"))
    assert rec[0]["rc"] != 0 and "error" in rec[0]
