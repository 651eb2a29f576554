"""The port's host superpixels (``videowalk_tpu_torch/data/superpixels.py``,
``native/``) against the JAX package's (``videowalk_tpu/data/superpixels.py``)
on seeded frames (64x64, and 256x256 for the C++ paths).

Both packages' C++ libraries are built by the same g++ from the same code
(the port's copy of ``superpixels.cc``), so labels are compared bitwise,
also Felzenszwalb's, whose ``std::sort`` is unstable.

Without cv2 (the port's handle ``_cv2`` returning None, as on a machine
without it): ``_normalize_uint8`` bitwise cv2's; the Lab conversion
(``ops/slic_device.rgb_to_lab``: the textbook sRGB curve and D65 white
where cv2 interpolates its gamma table and uses its own white point)
within 0.5 Lab units of ``cv2.cvtColor``; the FH blur within 1e-6 of
``cv2.GaussianBlur`` (f32 sums in another order, a few ulp at [0, 1]);
SLIC labels equal to the cv2 path's on a piecewise-constant frame, and on a
textured frame on >= 90% of pixels (the share is printed)."""

import os

import numpy as np
import pytest
import torch

from videowalk_tpu.data import superpixels as J

from videowalk_tpu_torch import native
from videowalk_tpu_torch.data import superpixels as P

torch.set_num_threads(1)


def blocks(h, seed, cell=16, noise=0.05):
    """``(h, h, 3)`` f32 in [0, 1]: cells of ``cell`` px of seeded colours,
    plus seeded noise."""
    rng = np.random.RandomState(seed)
    n = -(-h // cell)
    img = np.kron(rng.rand(n, n, 3), np.ones((cell, cell, 1)))[:h, :h]
    img = img + noise * rng.randn(h, h, 3)
    return np.clip(img, 0, 1).astype(np.float32)


def textured(h, seed):
    """A smooth seeded colour field with a square on it."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :h] / h
    img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (rng.rand() * 3 * x
                                                    + rng.rand() * 2 * y
                                                    + rng.rand()))
                    for _ in range(3)], -1)
    img[h // 4:h // 2, h // 3:2 * h // 3] = rng.rand(3)
    return (img + 0.02 * rng.randn(h, h, 3)).clip(0, 1).astype(np.float32)


FRAMES = {"blocks64": lambda: blocks(64, 0), "textured64": lambda: textured(64, 1),
          "blocks256": lambda: blocks(256, 2, cell=24),
          "textured256": lambda: textured(256, 3)}


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_native_slic_and_fh_equal_the_jax_package(frame):
    img = FRAMES[frame]()
    for n, c in ((9, 30.0), (36, 50.0)):
        got = P.compute_sp_slic(img, n, c)
        assert got.dtype == np.int32 and got.shape == img.shape[:2]
        np.testing.assert_array_equal(got, J.compute_sp_slic(img, n, c))
    np.testing.assert_array_equal(
        P.compute_sp_slic(img, 9, 30.0, enforce_connectivity=False),
        J.compute_sp_slic(img, 9, 30.0, enforce_connectivity=False))
    fh = P.compute_sp_FH(img)
    np.testing.assert_array_equal(fh, J.compute_sp_FH(img))
    np.testing.assert_array_equal(P.compute_sp_FH(img * 255),
                                  J.compute_sp_FH(img * 255))
    if frame == "blocks256":
        # FH at scale 600 on [0, 1] frames merges into few, large segments
        assert fh.max() >= 3


@pytest.mark.parametrize("frame", ["blocks64", "textured64"])
def test_numpy_slic_equals_the_jax_package(frame):
    img = FRAMES[frame]()
    got = P.compute_sp_slic(img, 9, 30.0, backend="numpy")
    np.testing.assert_array_equal(got, J.compute_sp_slic(img, 9, 30.0,
                                                         backend="numpy"))
    assert len(np.unique(got)) > 4


def test_device_backend_is_the_port_slic_on_the_cpu():
    from videowalk_tpu_torch.ops.slic_device import slic

    img = textured(64, 4)
    got = P.compute_sp_slic(img, 9, 30.0, backend="device")
    img8 = P._normalize_uint8(img)
    want = slic(torch.from_numpy(img8[None].astype(np.float32)) / 255.0,
                9, 30.0)[0].numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown backend"):
        P.compute_sp_slic(img, 9, 30.0, backend="skimage")


@pytest.mark.parametrize("method", ["slic", "fh", "random"])
def test_compute_mask_equals_the_jax_package(method):
    """Three seeds each: the method draw of ``random`` (p = 0.5) and the
    randomized segment counts come from the same stream; the streams end
    in the same state."""
    video = np.stack([textured(64, s) for s in range(3)])      # (T, H, W, C)
    for seed in range(3):
        rp, rj = np.random.RandomState(seed), np.random.RandomState(seed)
        for layout in (video, np.moveaxis(video, -1, 1)):
            got = P.compute_mask(layout, method, 9, 0.5, True, 6, 30.0, rp)
            want = J.compute_mask(layout, method, 9, 0.5, True, 6, 30.0, rj)
            assert got.shape == (3, 3, 64, 64)
            np.testing.assert_array_equal(got, want)
        assert rp.randint(1 << 30) == rj.randint(1 << 30)
    with pytest.raises(ValueError, match="unknown sp_method"):
        P.compute_mask(video, "quick", 9, 0.5, False, 0, 30.0)


def test_host_sp_mask_follows_the_dataset_options():
    import types

    video = np.stack([blocks(64, s) for s in range(4)])
    ds = types.SimpleNamespace(
        sp_method="slic", sp_backend="host", num_components=9, prob=1.0,
        randomise_superpixels=False, randomise_superpixels_range=0,
        compactness=30.0)
    got = P.host_sp_mask({"whole_unnorm": video}, ds,
                         np.random.RandomState(0))
    want = J.compute_mask(video, "slic", 9, 1.0, False, 0, 30.0,
                          np.random.RandomState(0))[:, 0]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for over in (dict(sp_method="none"), dict(sp_backend="device")):
        other = types.SimpleNamespace(**{**vars(ds), **over})
        assert P.host_sp_mask({}, other, None).shape == (0,)


@pytest.mark.parametrize("dtype", ["float32", "float64", "uint8"])
def test_normalize_without_cv2_is_bitwise_cv2s(dtype, monkeypatch):
    rng = np.random.RandomState(6)
    imgs = [textured(64, 7), blocks(64, 8) * 3.7 - 1.2,
            rng.rand(32, 48, 3) * 0.01 + 0.4,
            np.full((8, 8, 3), 0.25), np.linspace(0, 1, 768).reshape(16, 16, 3)]
    for img in imgs:
        img = (img * 255).clip(0, 255).astype(np.uint8) if dtype == "uint8" \
            else img.astype(dtype)
        want = P._normalize_uint8(img)                  # cv2
        with monkeypatch.context() as m:
            m.setattr(P, "_cv2", lambda: None)
            got = P._normalize_uint8(img)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_lab_and_blur_without_cv2_are_near_cv2s(monkeypatch):
    for seed in range(3):
        img = textured(64, seed)
        img8 = (img * 255).astype(np.uint8)
        lab_cv2, blur_cv2 = P._rgb_to_lab_f32(img8), P._gaussian_blur(img, 0.5)
        with monkeypatch.context() as m:
            m.setattr(P, "_cv2", lambda: None)
            lab, blur = P._rgb_to_lab_f32(img8), P._gaussian_blur(img, 0.5)
        assert lab.dtype == np.float32 and lab.shape == (64, 64, 3)
        np.testing.assert_allclose(lab, lab_cv2, rtol=0, atol=0.5)
        np.testing.assert_allclose(blur, blur_cv2, rtol=0, atol=1e-6)
    import cv2

    assert (np.asarray(cv2.getGaussianKernel(5, 0.5, cv2.CV_32F)).ravel()
            == P._gaussian_kernel(0.5)).all()


def test_slic_without_cv2_on_flat_and_textured_frames(monkeypatch):
    flat = blocks(64, 9, noise=0.0)
    tex = textured(256, 10)
    want = [P.compute_sp_slic(f, 36, 50.0) for f in (flat, tex)]
    fh_want = P.compute_sp_FH(flat)
    monkeypatch.setattr(P, "_cv2", lambda: None)
    got = [P.compute_sp_slic(f, 36, 50.0) for f in (flat, tex)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(P.compute_sp_FH(flat), fh_want)
    share = float((got[1] == want[1]).mean())
    print(f"SLIC labels without cv2 equal to cv2's on {share:.4f} of a "
          f"textured 256x256 frame")
    assert share >= 0.9


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError, match=r"host C\+\+ build failed.*false"):
        native.build("superpixels")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build("superpixels")
    assert os.listdir(tmp_path / "build") == []        # no stray library


def test_the_library_is_built_from_the_port_source():
    lib = native.build("superpixels")
    assert os.path.dirname(lib) == native.BUILD_DIR
    assert os.path.basename(lib).startswith("libsuperpixels-")
    assert P._native()._name == lib
