"""The port's launch recipes, ``train_torch.sh`` and ``test_torch.sh``,
against ``train.sh`` and ``test.sh``: the same environment defaults and the
same flags, command by command (the scripts' text is parsed, so the recipes
cannot drift apart), and no module of the JAX package named. Then each is
run as a user runs it, with ``--device cpu`` through ``"$@"``:
``test_torch.sh`` on ``tests/_synth.py``'s DAVIS tree with a
``make_crw_checkpoint`` ``.pth`` gives the J&F that the JAX package's
modules give on the same tree and file; ``train_torch.sh`` on the synthetic
Kinetics tree, at a small size, writes a ``checkpoint.pth`` that the
port's eval loads. The eval writes its images without imageio, which the
card's machine lacks.

Tolerance: the J&F as ``davis_metrics`` prints it (4 decimals) equals the
JAX chain's, rounded alike."""

import os
import re
import shlex
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from _synth import make_crw_checkpoint, make_davis_tree, make_kinetics_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_OF = {"train.py": "videowalk_tpu_torch.cli.train",
           "test.py": "videowalk_tpu_torch.cli.test"}


def commands(name: str) -> dict:
    """A launch recipe's environment defaults (``VAR=${VAR:-x}``) and its
    ``python`` commands as (program, arguments): the program a script's
    name or a ``-m`` module."""
    with open(os.path.join(ROOT, name)) as fh:
        text = fh.read().replace("\\\n", " ")
    env, cmds = {}, []
    for line in text.splitlines():
        m = re.fullmatch(r"(\w+)=\$\{(\w+):-(.*)\}", line.strip())
        if m and m[1] == m[2]:
            env[m[1]] = m[3]
        if line.startswith("python"):
            words = shlex.split(line, comments=True)[1:]
            if words[0] == "-m":
                words.pop(0)
            cmds.append((words[0], words[1:]))
    return dict(env=env, cmds=cmds)


@pytest.mark.parametrize("jax_name,port_name", [("train.sh", "train_torch.sh"),
                                                ("test.sh", "test_torch.sh")])
def test_recipes_carry_the_jax_recipes_flags(jax_name, port_name):
    """Each ``python`` command of the port's recipe runs the port's
    counterpart of the JAX recipe's command, with its arguments verbatim;
    the environment defaults are the same; the port's recipe names no
    module of the JAX package."""
    want, got = commands(jax_name), commands(port_name)
    assert got["env"] == want["env"] and want["env"]
    assert len(got["cmds"]) == len(want["cmds"]) >= 1
    for (prog, args), (jprog, jargs) in zip(got["cmds"], want["cmds"]):
        jmod = PORT_OF.get(jprog, jprog.replace("videowalk_tpu.",
                                                "videowalk_tpu_torch.", 1))
        assert prog == jmod, (prog, jprog)
        assert args == jargs
    assert any("--data-parallel" in a or "--cropSize" in a
               for _, a in got["cmds"])
    with open(os.path.join(ROOT, port_name)) as fh:
        text = fh.read()
    assert not re.search(r"videowalk_tpu(?!_torch)|\bjax\b|train\.py|"
                         r"test\.py", text)
    assert '"$@"' in text


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", PATH=os.path.dirname(sys.executable)
               + os.pathsep + os.environ["PATH"], **extra)
    return env


def _run(script: str, env: dict, *args) -> str:
    res = subprocess.run(["bash", script, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def _jf(stdout: str) -> float:
    m = re.search(r"'J&F-Mean': ([0-9.]+)", stdout)
    assert m, stdout[-2000:]
    return float(m[1])


def test_test_recipe_gives_the_jax_chains_jf(tmp_path):
    """``bash test_torch.sh --device cpu`` on a DAVIS tree with a JAX-written
    ``.pth``: the J&F (and every object's J and F) that the JAX package's
    ``cli.test`` -> ``convert_all`` -> ``evaluate_davis`` give at test.sh's
    flags on the same tree and file."""
    from videowalk_tpu.cli.test import main as jax_test
    from videowalk_tpu.eval.convert_davis import convert_all
    from videowalk_tpu.eval.davis_metrics import evaluate_davis
    from videowalk_tpu.eval.make_davis_vallist import make_list

    davis = make_davis_tree(str(tmp_path / "DAVIS"), hw=64, frames=8)
    ckpt = make_crw_checkpoint(str(tmp_path / "model.pth"), "scratch", seed=5)
    out = str(tmp_path / "port")
    stdout = _run("test_torch.sh", _env(DAVIS=davis, CKPT=ckpt, OUT=out,
                                        VALLIST=str(tmp_path / "list.txt")),
                  "--device", "cpu")
    assert "==> Resuming from checkpoint.." in stdout
    assert sorted(os.listdir(out + "_converted")) == ["video0", "video1"]

    lst = tmp_path / "jax_list.txt"
    lst.write_text("\n".join(make_list(davis)) + "\n")
    jax_test(types.SimpleNamespace(
        filelist=str(lst), save_path=str(tmp_path / "jax"), resume=ckpt,
        model_type="scratch", head_depth=-1, remove_layers=["layer4"],
        no_l2=False, topk=10, videoLen=20, radius=12.0, temperature=0.05,
        cropSize=-1, imgSize=-1, long_mem=[0], texture=False, round=False,
        norm_mask=False, workers=4, batchSize=1, manualSeed=777, finetune=0,
        pca_vis=False, visdom=False))
    convert_all(str(tmp_path / "jax"), str(tmp_path / "jax_c"), davis)
    want = evaluate_davis(str(tmp_path / "jax_c"), davis)
    assert _jf(stdout) == round(want["J&F-Mean"], 4)
    objects = re.findall(r"^(video\d_\d: J=\S+ F=\S+)$", stdout, re.M)
    assert len(objects) == 2 and 0.0 < want["J&F-Mean"] <= 1.0


def test_test_recipe_stops_at_a_failed_step(tmp_path):
    """An eval that fails (here a propagation backend the port refuses)
    stops the recipe: no conversion, no J&F. (Run on, as test.sh runs on,
    the metrics would score the missing masks as empty and print a J&F of
    0 with exit status 0.)"""
    davis = make_davis_tree(str(tmp_path / "DAVIS"), vids=("video0",),
                            hw=32, frames=3)
    res = subprocess.run(
        ["bash", "test_torch.sh", "--device", "cpu", "--prop-backend", "xla"],
        cwd=ROOT, env=_env(DAVIS=davis, OUT=str(tmp_path / "out"),
                           VALLIST=str(tmp_path / "list.txt")),
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "--prop-backend xla" in res.stderr
    assert "J&F" not in res.stdout
    assert not os.path.exists(tmp_path / "out_converted")


def test_train_recipe_writes_a_checkpoint_the_eval_loads(tmp_path):
    """``bash train_torch.sh --device cpu`` on the synthetic Kinetics tree
    with only size and step overrides (64 px frames, 16 px patches,
    dilation 9, 8 segments, batch 2, 3 steps): exit 0, the metadata cache
    and ``checkpoint.pth`` written; ``test_torch.sh --device cpu`` loads
    its encoder."""
    kin = make_kinetics_tree(str(tmp_path / "kin"))
    out = tmp_path / "run"
    env = _env(DATA_PATH=os.path.join(kin, "val_256"),
               CACHE_PATH=str(out / "cache.pt"))
    stdout = _run("train_torch.sh", env, "--device", "cpu",
                  "--img-size", "64", "--patch-size", "16", "16", "3",
                  "--dilation-kernel-size", "9", "--num-sp", "8",
                  "--batch-size", "2", "--workers", "2", "--epochs", "1",
                  "--steps-per-epoch", "3", "--print-freq", "1",
                  "--output-dir", str(out / "ckpt"),
                  "--logs-dir", str(out / "logs"))
    assert "Epoch: [0]  [2/3]" in stdout
    assert os.path.isfile(out / "cache.pt")
    ckpt = str(out / "ckpt" / "checkpoint.pth")
    assert os.path.isfile(ckpt)

    davis = make_davis_tree(str(tmp_path / "DAVIS"), vids=("video0",),
                            hw=64, frames=4)
    stdout = _run("test_torch.sh", _env(
        DAVIS=davis, CKPT=ckpt, OUT=str(tmp_path / "res"),
        VALLIST=str(tmp_path / "list.txt")), "--device", "cpu")
    loaded = re.search(r"Loading keys:\s+(\[.*?\])", stdout, re.S)
    assert loaded and "'encoder.model.layer3.1.conv2.weight'" in loaded[1]
    assert 0.0 <= _jf(stdout) <= 1.0


def test_eval_images_need_no_imageio(tmp_path, monkeypatch):
    """``dump_predictions`` with imageio unimportable writes the bytes that
    the JAX package's (imageio's) writes."""
    from videowalk_tpu.eval.test_utils import dump_predictions as jax_dump

    from videowalk_tpu_torch.eval.test_utils import dump_predictions

    rng = np.random.RandomState(3)
    pred = rng.rand(6, 10, 3).astype(np.float32)
    lbl_set = np.array([[0, 0, 0], [128, 0, 0], [0, 128, 0]], np.uint8)
    img = rng.randint(0, 255, (48, 80, 3)).astype(np.uint8)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_dump(pred, lbl_set, img, str(tmp_path / "jax" / "0_1"))
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(ImportError):
        import imageio  # noqa: F401
    dump_predictions(pred, lbl_set, img, str(tmp_path / "port" / "0_1"))
    for f in ("0_1_blend.jpg", "0_1_mask.png"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
