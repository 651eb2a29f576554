"""The port's VIP parsing metrics and driver path against the JAX
package's, on the synthetic VIP fixture of ``tests/test_vip_pipeline.py``:
``fast_hist``, ``show_result`` and ``compute_hist`` exactly (the edge cases
of that file included), and ``cli.test`` on a ``VIP`` filelist writing its
masks under ``videos/`` as the JAX driver does, from one ``.pth``."""

import os
import types

import numpy as np
import pytest
import torch

from PIL import Image

from videowalk_tpu.eval import eval_vip as jv

from videowalk_tpu_torch.eval import eval_vip as tv

from _synth import make_crw_checkpoint
from test_vip_pipeline import vip_root  # noqa: F401  (fixture)

torch.set_num_threads(1)


def test_fast_hist_equals_jax():
    rng = np.random.RandomState(0)
    a = rng.randint(-2, 23, (64, 80))
    b = rng.randint(0, 256, (64, 80)) % 25
    np.testing.assert_array_equal(tv.fast_hist(a, b, tv.N_CL),
                                  jv.fast_hist(a, b, jv.N_CL))
    # the out-of-range prediction case of test_vip_pipeline.py
    a, b = np.array([0, 1, 2, 3]), np.array([0, 255, 2, 19])
    h = tv.fast_hist(a, b, tv.N_CL)
    np.testing.assert_array_equal(h, jv.fast_hist(a, b, jv.N_CL))
    assert h.sum() == 3 and h[3, 19] == 1


def test_show_result_equals_jax():
    rng = np.random.RandomState(1)
    hist = rng.randint(0, 50, (20, 20)).astype(float)
    hist[5] = 0                         # a class absent from the GT
    hist[:, 7] = 0                      # and one never predicted
    hist[9] = hist[:, 9] = 0            # and one absent from both: NaN IoU
    got = tv.show_result(hist)
    assert got == jv.show_result(hist)
    assert tv.CLASSES == jv.CLASSES and tv.N_CL == jv.N_CL == 20
    with pytest.raises(RuntimeError, match="empty confusion histogram"):
        tv.show_result(np.zeros((20, 20)))


def _cli_args(fl, save, ckpt):
    return types.SimpleNamespace(
        filelist=fl, save_path=save, resume=ckpt,
        model_type="scratch_zeropad", head_depth=-1,
        remove_layers=["layer4"], no_l2=False, topk=5, videoLen=2,
        radius=4.0, temperature=0.05, cropSize=-1, imgSize=-1, long_mem=[0],
        texture=False, round=False, norm_mask=False, workers=0, batchSize=1,
        manualSeed=777, finetune=0, pca_vis=False, visdom=False)


def test_vip_driver_and_compute_hist_equal_jax(vip_root, tmp_path):
    """Both eval CLIs from one ``.pth``: the same files under
    ``videos1/``, masks equal on >= 99% of pixels; ``compute_hist`` of
    both modules equal on each tree (the port's with a stray file, a
    prediction with no GT frame and one at another size added), and so
    are ``show_result``'s metrics."""
    import cv2

    from videowalk_tpu.cli.test import main as jax_main

    from videowalk_tpu_torch.cli.test import main as torch_main

    root, fl = vip_root
    ckpt = make_crw_checkpoint(str(tmp_path / "model.pth"), "scratch_zeropad",
                               seed=7)
    jax_main(_cli_args(fl, str(tmp_path / "jax"), ckpt))
    port_args = _cli_args(fl, str(tmp_path / "port"), ckpt)
    port_args.device = "cpu"
    stats = torch_main(port_args)
    assert [s["targets"] for s in stats] == [6]
    names = sorted(os.listdir(tmp_path / "jax" / "videos1"))
    assert sorted(os.listdir(tmp_path / "port" / "videos1")) == names
    masks = [n for n in names if n.endswith(".png") and "blend" not in n]
    assert len(masks) == 6
    for n in masks:
        a = cv2.imread(str(tmp_path / "port" / "videos1" / n))
        b = cv2.imread(str(tmp_path / "jax" / "videos1" / n))
        assert (a == b).all(-1).mean() >= 0.99

    gt = os.path.join(root, "Category_ids")
    (tmp_path / "port" / "stray.txt").write_text("not a video")
    Image.fromarray(np.full((64, 64, 3), 4, np.uint8)).save(
        tmp_path / "port" / "videos1" / "999999.png")          # no GT frame
    small = cv2.imread(str(tmp_path / "port" / "videos1" / masks[0]))
    cv2.imwrite(str(tmp_path / "port" / "videos1" / masks[0]),
                cv2.resize(small, (32, 32), interpolation=cv2.INTER_NEAREST))
    for tree in ("port", "jax"):
        got = tv.compute_hist(str(tmp_path / tree), gt)
        np.testing.assert_array_equal(
            got, jv.compute_hist(str(tmp_path / tree), gt))
        assert tv.show_result(got) == jv.show_result(got)
    assert tv.compute_hist(str(tmp_path / "port"), gt).sum() == 6 * 64 * 64
