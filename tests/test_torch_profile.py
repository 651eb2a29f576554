"""``--profile-dir`` in the port's CLIs (``utils/profile.py``): the trainer
traces steps 5-9 of its first epoch and writes the trace however the epoch
ends, leaving no profiler running (the JAX test
``tests/test_cli_train.py::test_train_profile_dir_writes_trace``); the eval
traces one warm video. The ``-m cuda`` case checks that a trace on the card
names the port's hand kernels (``rconv_slab``, ``walk_``, ``dilate``),
which are launched through ctypes. No JAX here, so the file runs with
``--noconftest`` where JAX is not installed."""

import json
import os
import types

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.cli import train as cli
from videowalk_tpu_torch.utils.arguments import train_args

from _synth import make_crw_checkpoint, make_davis_tree, make_kinetics_tree

torch.set_num_threads(1)


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def _events(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


@pytest.fixture(scope="module")
def kinetics_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kin"))
    make_kinetics_tree(root)
    return os.path.join(root, "val_256")


def _argv(data, out, *extra):
    return ["--device", "cpu", "--data-path", data, "--frame-aug", "grid",
            "--clip-len", "4", "--temp", "0.05", "--model-type",
            "scratch_zeropad", "--remove-layers", "layer4", "--img-size",
            "32", "--patch-size", "16", "16", "3", "--batch-size", "1",
            "--epochs", "1", "--workers", "2", "--prob", "1",
            "--output-dir", out, "--logs-dir", os.path.join(out, "logs"),
            "--cache-path", os.path.join(out, "cache.pt"), *extra]


def test_train_traces_steps_5_to_9(kinetics_root, tmp_path):
    prof = str(tmp_path / "trace")
    state = cli.main(train_args(_argv(
        kinetics_root, str(tmp_path / "o"), "--steps-per-epoch", "7",
        "--profile-dir", prof)))
    assert state.step == 7 and not _profiling()
    traced = os.listdir(prof)
    assert traced == ["train_epoch0_steps5-9.pt.trace.json"]
    names = {e.get("name", "") for e in _events(os.path.join(prof,
                                                             traced[0]))}
    assert any(n.startswith("aten::") for n in names)


def test_train_trace_is_written_when_a_step_fails(kinetics_root, tmp_path,
                                                  monkeypatch):
    real = cli.make_train_step

    def make_train_step():
        step, calls = real(), []

        def failing(state, batch, gen, sp_mask=None):
            calls.append(1)
            if len(calls) == 7:
                raise RuntimeError("step 6 failed")
            return step(state, batch, gen, sp_mask=sp_mask)
        return failing

    monkeypatch.setattr(cli, "make_train_step", make_train_step)
    prof = str(tmp_path / "trace")
    with pytest.raises(RuntimeError, match="step 6 failed"):
        cli.main(train_args(_argv(kinetics_root, str(tmp_path / "o"),
                                  "--steps-per-epoch", "12",
                                  "--profile-dir", prof)))
    assert not _profiling()
    assert os.path.getsize(os.path.join(
        prof, "train_epoch0_steps5-9.pt.trace.json")) > 0


def test_eval_traces_one_warm_video(tmp_path):
    from videowalk_tpu_torch.cli import test as cli_test
    from videowalk_tpu_torch.eval.make_davis_vallist import make_list

    root = str(tmp_path / "DAVIS")
    make_davis_tree(root, hw=64, frames=6)
    lst = tmp_path / "davis_vallist.txt"
    lst.write_text("\n".join(make_list(root)) + "\n")
    ckpt = make_crw_checkpoint(str(tmp_path / "model.pth"), "scratch", seed=3)
    prof = str(tmp_path / "trace")
    args = types.SimpleNamespace(
        filelist=str(lst), save_path=str(tmp_path / "res"), resume=ckpt,
        model_type="scratch", head_depth=-1, remove_layers=["layer4"],
        no_l2=False, topk=5, videoLen=3, radius=6.0, temperature=0.05,
        cropSize=-1, imgSize=-1, long_mem=[0], texture=False, round=False,
        norm_mask=False, workers=0, batchSize=1, manualSeed=777, finetune=0,
        pca_vis=False, visdom=False, device="cpu", profile_dir=prof)
    stats = cli_test.main(args)
    assert len(stats) == 2 and not _profiling()
    assert os.listdir(prof) == ["test_video1.pt.trace.json"]
    names = {e.get("name", "") for e in _events(os.path.join(
        prof, "test_video1.pt.trace.json"))}
    assert any(n.startswith("aten::") for n in names)


class _RawClips:
    """``Kinetics400``'s item contract for ``--augs-backend device``:
    ``({"raw": (T, 288, 288, 3) uint8}, empty ids, label)``."""

    def __init__(self, n: int, clip_len: int, seed: int):
        rng = np.random.RandomState(seed)
        base = rng.randint(0, 256, (n, 36, 36, 3)).astype(np.uint8)
        self.clips = np.stack([[np.roll(np.kron(b, np.ones((8, 8, 1),
                                                           np.uint8)),
                                        3 * t, 1) for t in range(clip_len)]
                               for b in base])

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return {"raw": self.clips[i]}, np.zeros((0,), np.int32), 0


def _seed_with_both_paths_in(steps, prob=0.5) -> int:
    for seed in range(100):
        rs = np.random.RandomState(seed)
        paths = []
        for _ in range(max(steps) + 1):
            paths.append(bool(rs.choice([True, False], p=[prob, 1 - prob])))
            rs.random_sample()
        if {paths[s] for s in steps} == {True, False}:
            return seed
    raise AssertionError("no seed")


@pytest.mark.cuda
def test_card_trace_names_the_hand_kernels(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prof = str(tmp_path / "trace")
    seed = _seed_with_both_paths_in(range(5, 10))
    args = train_args([
        "--device", "cuda", "--data-path", "in-memory", "--frame-aug", "grid",
        "--clip-len", "4", "--temp", "0.05", "--dropout", "0.1",
        "--model-type", "scratch", "--batch-size", "2", "--prob", "0.5",
        "--num-sp", "36", "--compactness", "50", "--dilate-superpixels",
        "--dilation-kernel-size", "55", "--dtype", "bfloat16",
        "--augs-backend", "device", "--epochs", "1", "--steps-per-epoch",
        "11", "--workers", "2", "--seed", str(seed), "--output-dir",
        str(tmp_path / "o"), "--profile-dir", prof])
    cli.main(args, dataset=_RawClips(24, 4, seed=1))
    assert not _profiling()
    kernels = [e["name"] for e in _events(os.path.join(
        prof, "train_epoch0_steps5-9.pt.trace.json"))
        if e.get("cat") == "kernel"]
    for part in ("rconv_slab", "walk_", "dilate", "slic_"):
        assert any(part in k for k in kernels), part
