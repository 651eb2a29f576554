"""The port's JHMDB pose path against the JAX package's on the synthetic
JHMDB fixture of ``tests/test_jhmdb_pipeline.py``: ``JhmdbSet`` items,
``draw_labelmap_np``, ``process_pose`` and ``vis_pose``, the PCK core and
``compute_pck``, and ``cli.test`` (keypoints ``{i}.dat``, ``--pca-vis``) on
one ``.pth``.

Tolerances: labels within 1e-6 and the label set exact; the modules'
outputs on the same inputs exact. The two CLIs' soft predictions differ by
f32 rounding (atol 1e-4, ``tests/test_torch_eval.py``), so their keypoints
are held within 1e-4 of a cell (top-3 weighted averages of those
predictions) and the PCK dicts computed from them are equal, as are their
PCA images (uint8 after a min-max scale)."""

import os
import types

import numpy as np
import pytest
import torch

from videowalk_tpu.data import jhmdb as jj
from videowalk_tpu.eval import eval_pck as jpck
from videowalk_tpu.eval import test_utils as jtu

from videowalk_tpu_torch.data import jhmdb as tj
from videowalk_tpu_torch.eval import eval_pck as tpck
from videowalk_tpu_torch.eval import test_utils as ttu

from _synth import make_crw_checkpoint
from test_jhmdb_pipeline import jhmdb_root  # noqa: F401  (fixture)

torch.set_num_threads(1)


def _ds_args(fl, **over):
    a = types.SimpleNamespace(filelist=fl, imgSize=-1, videoLen=2,
                              mapScale=np.array([8, 8]), texture=False,
                              round=False, workers=0)
    for k, v in over.items():
        setattr(a, k, v)
    return a


@pytest.mark.parametrize("over", [{}, {"imgSize": 32, "workers": 3}],
                         ids=["native", "resized"])
def test_jhmdb_set_equals_jax(jhmdb_root, over):
    _, fl = jhmdb_root
    for i in range(2):
        got = tj.JhmdbSet(_ds_args(fl, **over))[i]
        want = jj.JhmdbSet(_ds_args(fl, **over))[i]
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[2], want[2], atol=1e-6)
        np.testing.assert_allclose(got[3], want[3], atol=1e-6)
        assert got[2].dtype == want[2].dtype == np.float32
        np.testing.assert_array_equal(got[4], want[4])     # the label set
        assert got[5] == want[5]


@pytest.mark.parametrize("sigma,kind", [(0.5, "Gaussian"), (2.0, "Gaussian"),
                                        (1.0, "Cauchy")])
def test_draw_labelmap_equals_jax(sigma, kind):
    rng = np.random.RandomState(3)
    for pt in list(rng.rand(20, 2) * 50 - 5) + [(-9.0, 3.0), (3.0, 60.0)]:
        a = np.zeros((40, 44))
        b = np.zeros((40, 44))
        np.testing.assert_array_equal(
            tj.draw_labelmap_np(a, pt, sigma, kind),
            jj.draw_labelmap_np(b, pt, sigma, kind))


def test_process_pose_and_vis_pose_equal_jax():
    rng = np.random.RandomState(0)
    lblset = tj.pose_lblset(15)
    for trial in range(4):
        pred = rng.rand(40, 40, 16).astype(np.float32)
        if trial == 1:
            pred[..., 3] = 0            # an invisible joint
        if trial == 2:
            pred[5, 7, 1:] = 10.0       # ties through the top 3
        for topk in (1, 3):
            got = ttu.process_pose(pred, lblset, topk)
            want = jtu.process_pose(pred, lblset, topk)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        img = rng.randint(0, 255, (320, 320, 3), np.uint8)
        pts = got[0] * 8
        before = img.copy()
        np.testing.assert_array_equal(ttu.vis_pose(img, pts),
                                      jtu.vis_pose(img, pts))
        np.testing.assert_array_equal(img, before)   # drawn on a copy


def test_pck_core_and_compute_pck_equal_jax(jhmdb_root, tmp_path):
    """The same ``.dat`` files (seeded keypoints, some invisible) through
    both ``compute_pck``; the core at another feature grid."""
    _, fl = jhmdb_root
    rng = np.random.RandomState(4)
    gts, h, w = jpck.load_gt(fl)
    for i, gt in enumerate(gts):
        pred = gt[:, :, :].copy() / 64 * 40 + rng.randn(*gt.shape) * 2
        pred[0][rng.rand(*pred[0].shape) < 0.1] = -1
        pred.dump(str(tmp_path / f"{i}.dat"))
    got = tpck.compute_pck(fl, str(tmp_path))
    assert got == jpck.compute_pck(fl, str(tmp_path))
    assert sorted(got) == [0.1, 0.2, 0.3, 0.4, 0.5]
    assert [got[t] for t in sorted(got)] == sorted(got.values())
    gts2, h2, w2 = tpck.load_gt(fl)
    assert (h2, w2) == (h, w)
    preds = [np.load(str(tmp_path / f"{i}.dat"), allow_pickle=True)
             for i in range(2)]
    assert tpck.pck_scores(gts2, preds, list(zip(h, w)),
                           feat_res=(40, 30)) == \
        jpck.compute_pck(fl, str(tmp_path), feat_res=(40, 30))


def _cli_args(fl, save, ckpt, **over):
    a = types.SimpleNamespace(
        filelist=fl, save_path=save, resume=ckpt,
        model_type="scratch_zeropad", head_depth=-1,
        remove_layers=["layer4"], no_l2=False, topk=5, videoLen=2,
        radius=4.0, temperature=0.05, cropSize=-1, imgSize=-1, long_mem=[0],
        texture=False, round=False, norm_mask=False, workers=0, batchSize=1,
        manualSeed=777, finetune=0, pca_vis=False, visdom=False)
    for k, v in over.items():
        setattr(a, k, v)
    return a


@pytest.fixture(scope="module")
def both_clis(jhmdb_root, tmp_path_factory):
    """Both eval CLIs on the fixture with one ``.pth``, ``--pca-vis`` on."""
    from videowalk_tpu.cli.test import main as jax_main

    from videowalk_tpu_torch.cli.test import main as torch_main

    _, fl = jhmdb_root
    out = tmp_path_factory.mktemp("jhmdb_eval")
    ckpt = make_crw_checkpoint(str(out / "model.pth"), "scratch_zeropad",
                               seed=6)
    jax_main(_cli_args(fl, str(out / "jax"), ckpt, pca_vis=True))
    stats = torch_main(_cli_args(fl, str(out / "port"), ckpt, pca_vis=True,
                                 device="cpu"))
    return fl, out, stats


def test_cli_keypoints_give_the_jax_pipelines_pck(both_clis):
    fl, out, stats = both_clis
    for i in range(2):
        got = np.load(str(out / "port" / f"{i}.dat"), allow_pickle=True)
        want = np.load(str(out / "jax" / f"{i}.dat"), allow_pickle=True)
        assert got.shape == want.shape == (2, 15, 8)
        np.testing.assert_allclose(got, want, atol=1e-4)
        np.testing.assert_array_equal(stats[i]["keypoints"], got)
    got = tpck.compute_pck(fl, str(out / "port"))
    assert got == jpck.compute_pck(fl, str(out / "jax"))


def test_cli_pca_vis_writes_the_jax_pngs(both_clis):
    from PIL import Image

    from videowalk_tpu.utils.visualize import pca_feats as jax_pca

    from videowalk_tpu_torch.utils.visualize import pca_feats

    _, out, _ = both_clis
    names = sorted(os.listdir(out / "jax" / "pca"))
    assert names == sorted(os.listdir(out / "port" / "pca"))
    assert names == ["0_0.png", "1_0.png"]
    for n in names:
        a = np.array(Image.open(out / "port" / "pca" / n))
        b = np.array(Image.open(out / "jax" / "pca" / n))
        assert a.shape == (32, 32, 3)
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(0)
    f = rng.randn(12, 16, 5, 6)
    for K, whiten in ((1, True), (2, False)):
        got, want = pca_feats(f, K, whiten), jax_pca(f, K, whiten)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
