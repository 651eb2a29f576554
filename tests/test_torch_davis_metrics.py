"""The port's DAVIS J&F (``videowalk_tpu_torch/eval/davis_metrics.py``)
against the JAX package's (``videowalk_tpu/eval/davis_metrics.py``): the
array core on the hand-enumerated masks of ``tests/test_davis_metrics.py``
and on seeded random masks at 480x854, the scipy dilation against
``cv2.dilate`` at 480p's radius, and ``evaluate_davis`` on a synthetic
DAVIS tree. Tolerance: none; every value is equal."""

import math
import os

import numpy as np
import pytest

import cv2
from PIL import Image

from videowalk_tpu.eval import davis_metrics as jdm

from videowalk_tpu_torch.eval import davis_metrics as tdm

from _synth import make_davis_tree


def _px(h, w, *yx):
    m = np.zeros((h, w), bool)
    for p in yx:
        m[p] = True
    return m


def _box(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), bool)
    m[y0:y1, x0:x1] = True
    return m


# (pred, gt) pairs of tests/test_davis_metrics.py
HAND = {
    "single_pixel": (_px(20, 20, (5, 5)), _px(20, 20, (5, 5))),
    "block_3x3": (_box(12, 12, 4, 7, 4, 7), _box(12, 12, 4, 7, 4, 7)),
    "interior": (_box(16, 16, 4, 12, 4, 12), _box(16, 16, 5, 12, 4, 12)),
    "full_frame": (np.ones((8, 8), bool), np.ones((8, 8), bool)),
    "shift_1px": (_px(20, 20, (5, 6)), _px(20, 20, (5, 5))),
    "shift_3px": (_px(20, 20, (5, 8)), _px(20, 20, (5, 5))),
    "thin_vs_thick": (_box(24, 24, 0, 24, 7, 10), _box(24, 24, 0, 24, 8, 9)),
    "empty_empty": (np.zeros((16, 16), bool), np.zeros((16, 16), bool)),
    "blob_empty": (_px(16, 16, (8, 8)), np.zeros((16, 16), bool)),
    "empty_blob": (np.zeros((16, 16), bool), _px(16, 16, (8, 8))),
    "jaccard_overlap": (_box(8, 8, 2, 6, 2, 6), _box(8, 8, 4, 8, 4, 8)),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_core_equals_jax_on_hand_cases(case):
    pred, gt = HAND[case]
    np.testing.assert_array_equal(tdm.seg2bmap(pred), jdm.seg2bmap(pred))
    np.testing.assert_array_equal(tdm.seg2bmap(gt), jdm.seg2bmap(gt))
    assert tdm.f_measure(pred, gt) == jdm.f_measure(pred, gt)
    assert tdm.jaccard(pred, gt) == jdm.jaccard(pred, gt)


def _blobs(rng, h, w, n):
    """``n`` random rectangles and discs, some touching the border."""
    m = np.zeros((h, w), bool)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(n):
        y, x = rng.randint(-20, h + 20), rng.randint(-20, w + 20)
        if rng.rand() < 0.5:
            m[max(y, 0):y + rng.randint(5, 120),
              max(x, 0):x + rng.randint(5, 200)] = True
        else:
            m |= (yy - y) ** 2 + (xx - x) ** 2 <= rng.randint(3, 60) ** 2
    return m


@pytest.mark.parametrize("seed", range(4))
def test_core_equals_jax_on_random_480p_masks(seed):
    rng = np.random.RandomState(seed)
    gt = _blobs(rng, 480, 854, 4)
    pred = gt.copy() if seed == 0 else _blobs(rng, 480, 854, 4)
    if seed == 3:                       # scattered single pixels
        pred ^= rng.rand(480, 854) < 0.002
    np.testing.assert_array_equal(tdm.seg2bmap(pred), jdm.seg2bmap(pred))
    assert tdm.f_measure(pred, gt) == jdm.f_measure(pred, gt)
    assert tdm.jaccard(pred, gt) == jdm.jaccard(pred, gt)
    if seed == 0:
        assert tdm.f_measure(pred, gt) == tdm.jaccard(pred, gt) == 1.0


@pytest.mark.parametrize("kind", ["boundary", "sparse", "edges"])
def test_scipy_dilation_equals_cv2_dilate_at_480p(kind):
    """Radius ceil(0.008 * ||(480, 854)||) = 8, the one 480p gives: the
    dilation with a zero border equals ``cv2.dilate`` bit for bit, also
    where the mask touches the frame's edges."""
    r = int(math.ceil(0.008 * np.linalg.norm((480, 854))))
    assert r == 8
    rng = np.random.RandomState(7)
    if kind == "boundary":
        m = tdm.seg2bmap(_blobs(rng, 480, 854, 6))
    elif kind == "sparse":
        m = rng.rand(480, 854) < 0.003
    else:
        m = np.zeros((480, 854), bool)
        m[0, ::7] = m[-1, ::5] = m[::3, 0] = m[::11, -1] = True
    se = tdm._disk(r)
    np.testing.assert_array_equal(se, jdm._disk(r))
    want = cv2.dilate(m.astype(np.uint8), se).astype(bool)
    np.testing.assert_array_equal(tdm.dilate(m, se), want)


@pytest.mark.parametrize("r", [1, 3, 8])
def test_dilation_of_small_masks_equals_cv2_dilate(r):
    """The dilation runs on the mask's bounding box grown by the radius:
    small and empty masks, near and at the frame's edges."""
    rng = np.random.RandomState(r)
    se = tdm._disk(r)
    for _ in range(50):
        m = np.zeros((60, 70), bool)
        for _ in range(rng.randint(0, 4)):
            y, x = rng.randint(0, 60), rng.randint(0, 70)
            m[y:y + rng.randint(1, 9), x:x + rng.randint(1, 9)] = True
        want = cv2.dilate(m.astype(np.uint8), se).astype(bool)
        np.testing.assert_array_equal(tdm.dilate(m, se), want)


def _write_predictions(root, davis, seed):
    """Indexed PNGs per video: the annotations moved by a seeded shift,
    with a second object id planted in some frames; one frame missing."""
    rng = np.random.RandomState(seed)
    ann = os.path.join(davis, "Annotations", "480p")
    for v in sorted(os.listdir(ann)):
        os.makedirs(os.path.join(root, v))
        for i, f in enumerate(sorted(os.listdir(os.path.join(ann, v)))):
            if v == "video1" and i == 4:
                continue                # scored as an empty prediction
            gt = np.array(Image.open(os.path.join(ann, v, f)))
            pred = np.roll(gt, rng.randint(-3, 4), axis=rng.randint(2))
            if rng.rand() < 0.3:
                y, x = rng.randint(0, 56, 2)
                pred[y:y + 8, x:x + 8] = 2
            Image.fromarray(pred.astype(np.uint8)).save(
                os.path.join(root, v, f))


def test_evaluate_davis_equals_jax(tmp_path):
    davis = make_davis_tree(str(tmp_path / "DAVIS"), hw=64, frames=8)
    # a second object in video0's ground truth
    ann0 = tmp_path / "DAVIS" / "Annotations" / "480p" / "video0"
    for f in sorted(os.listdir(ann0)):
        im = Image.open(ann0 / f)
        a = np.array(im)
        a[2:10, 40:52] = 2
        out = Image.fromarray(a, mode="P")
        out.putpalette(im.getpalette())
        out.save(ann0 / f)
    res = str(tmp_path / "results")
    _write_predictions(res, davis, seed=0)
    got = tdm.evaluate_davis(res, davis)
    want = jdm.evaluate_davis(res, davis)
    assert got == want
    assert 0.0 < got["J&F-Mean"] < 1.0
    for v in ("video0", "video1"):
        args = (os.path.join(res, v), str(ann0.parent / v))
        assert tdm.evaluate_sequence(*args) == jdm.evaluate_sequence(*args)
    assert sorted(tdm.evaluate_sequence(res + "/video0", str(ann0))) == [1, 2]


def test_evaluate_davis_refuses_an_empty_evaluation(tmp_path):
    davis = make_davis_tree(str(tmp_path / "DAVIS"), vids=("v",), hw=16,
                            frames=3)
    adir = tmp_path / "DAVIS" / "Annotations" / "480p" / "v"
    for f in os.listdir(adir):
        Image.fromarray(np.zeros((16, 16), np.uint8)).save(adir / f)
    with pytest.raises(ValueError, match="no object tracks evaluated"):
        tdm.evaluate_davis(str(tmp_path / "none"), davis)
    with pytest.raises(ValueError, match="no object tracks evaluated"):
        jdm.evaluate_davis(str(tmp_path / "none"), davis)
