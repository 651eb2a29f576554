"""The port's eval slice end to end on the CPU against the JAX eval CLI: the
same ``.pth`` checkpoint (``tests/_synth.make_crw_checkpoint``) and the same
64px synthetic DAVIS tree through ``cli.test.main`` of both packages. Soft
predictions must agree to atol 1e-4 (f32 encoder by different conv
algorithms, then f32 propagation) and the written masks on >= 99% of
pixels."""

import os
import types

import numpy as np
import pytest
import torch

from _synth import make_crw_checkpoint, make_davis_tree

torch.set_num_threads(1)


def _args(filelist, save_path, ckpt, **over):
    a = types.SimpleNamespace(
        filelist=filelist, save_path=save_path, resume=ckpt,
        model_type="scratch", head_depth=-1, remove_layers=["layer4"],
        no_l2=False, topk=5, videoLen=3, radius=6.0, temperature=0.05,
        cropSize=-1, imgSize=-1, long_mem=[0], texture=False, round=False,
        norm_mask=False, workers=0, batchSize=1, manualSeed=777, finetune=0,
        pca_vis=False, visdom=False)
    for k, v in over.items():
        setattr(a, k, v)
    return a


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    from videowalk_tpu.eval.make_davis_vallist import make_list

    root = str(tmp_path_factory.mktemp("DAVIS"))
    make_davis_tree(root, hw=64, frames=10)
    lst = tmp_path_factory.mktemp("lists") / "davis_vallist.txt"
    lst.write_text("\n".join(make_list(root)) + "\n")
    ckpt = make_crw_checkpoint(
        str(tmp_path_factory.mktemp("ckpt") / "model.pth"), "scratch", seed=3)
    return str(lst), ckpt


def _capture(monkeypatch, module):
    """Wrap ``module.dump_predictions`` to keep each soft prediction."""
    preds = {}
    orig = module.dump_predictions

    def dump(pred, lbl_map, img, prefix, **kw):
        preds[os.path.basename(prefix)] = np.array(pred)
        return orig(pred, lbl_map, img, prefix, **kw)

    monkeypatch.setattr(module, "dump_predictions", dump)
    return preds


@pytest.mark.parametrize("norm_mask", [False, True])
def test_eval_slice_matches_jax(fixture, tmp_path, monkeypatch, norm_mask):
    import cv2

    from videowalk_tpu.cli.test import main as jax_main
    from videowalk_tpu.eval import test_utils as jax_tu

    from videowalk_tpu_torch.cli.test import main as torch_main
    from videowalk_tpu_torch.eval import test_utils as torch_tu
    from videowalk_tpu_torch.ops.prop_sparse import prop_sparse

    filelist, ckpt = fixture
    want = _capture(monkeypatch, jax_tu)
    got = _capture(monkeypatch, torch_tu)
    jax_main(_args(filelist, str(tmp_path / "jax"), ckpt, norm_mask=norm_mask))
    before = prop_sparse.launches
    stats = torch_main(_args(filelist, str(tmp_path / "torch"), ckpt,
                             norm_mask=norm_mask, device="cpu"))
    assert prop_sparse.launches == before      # the CPU takes the plain path
    assert [s["targets"] for s in stats] == [10, 10]
    assert sorted(got) == sorted(want) and len(got) == 20
    for name in want:
        assert got[name].shape == want[name].shape == (8, 8, 2)
        np.testing.assert_allclose(got[name], want[name], atol=1e-4)
        m_got = cv2.imread(str(tmp_path / "torch" / f"{name}_mask.png"))
        m_want = cv2.imread(str(tmp_path / "jax" / f"{name}_mask.png"))
        assert (m_got == m_want).all(-1).mean() >= 0.99
    # the first target is the ground truth of frame 0
    assert got["0_0"].argmax(-1).max() == 1


def test_unported_flags_raise():
    """The flags still unported raise, naming themselves; the JHMDB and VIP
    filelists, ``--pca-vis``, ``--texture``, ``--encode-dtype bfloat16``,
    ``--profile-dir``, ``--data-parallel``, ``--distributed`` and every
    model type pass the check."""
    from videowalk_tpu_torch.cli.test import main
    from videowalk_tpu_torch.utils.arguments import check_supported, test_args

    for argv, flag in ((["--prop-backend", "xla"], "--prop-backend xla"),
                       (["--prop-backend", "tiled", "--data-parallel"],
                        "--prop-backend tiled")):
        with pytest.raises(NotImplementedError, match=flag):
            main(test_args(argv + ["--device", "cpu"]))
    for argv in (["--pca-vis"], ["--texture"], ["--profile-dir", "t"],
                 ["--data-parallel"], ["--distributed"],
                 ["--encode-dtype", "bfloat16"],
                 ["--filelist", "jhmdb_vallist.txt"],
                 ["--filelist", "VIP_vallist.txt"]) + tuple(
                     ["--model-type", t] for t in (
                         "scratch50", "imagenet18", "imagenet50", "moco50",
                         "timecycle", "uvc")):
        check_supported(test_args(argv))
    args = test_args(["--cropSize", "-1"])
    assert args.device == "cuda" and args.imgSize == -1


def test_vos_dataset_matches_jax(fixture):
    from videowalk_tpu.data.vos import VOSDataset as JaxVOS

    from videowalk_tpu_torch.data.vos import VOSDataset

    filelist, _ = fixture
    args = _args(filelist, "", "")
    args.mapScale = np.array([8, 8])
    a, b = VOSDataset(args)[1], JaxVOS(args)[1]
    for x, y in zip(a[:5], b[:5]):
        np.testing.assert_array_equal(x, y)
    assert a[5] == b[5]
