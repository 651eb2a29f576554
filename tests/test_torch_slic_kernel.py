"""The fused SLIC CUDA kernels (``videowalk_tpu_torch/ops/csrc/slic.cu``)
against their plain version ``ops/slic_device.py::slic`` on the card
(``-m cuda``; skipped where there is no card). No JAX here, so the file
runs with ``--noconftest`` where JAX is not installed.

The kernel takes the direct ``sum (f - c)^2``, the plain version the
expanded form, whose f32 rounding decides near-ties, and k-means carries a
differing pixel through its rounds. So: one assignment from the same
centers >= 99.9% equal labels on any input; a full run on structured frames
>= 99%; two runs of the kernel bitwise equal. The kernel lists, per 32x64
tile, the centers whose window can reach it, falls back to every active
center for a pixel with none in its window, sums clusters in int64 fixed
point and gathers the grid's start itself: ragged tiles (``CASES``),
``n_active`` down to 1, the finalize kernel behind ``return_centers`` and
the grid start are held on their own."""

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.ops import _build
from videowalk_tpu_torch.ops.slic import slic_fused
from videowalk_tpu_torch.ops.slic_device import (initial_centers, rgb_to_lab,
                                                 slic, slic_geometry)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def quadrants(B, h, w, seed):
    """Four colored quadrants plus 5% noise."""
    rng = np.random.RandomState(seed)
    img = np.zeros((B, h, w, 3), np.float32)
    img[:, :h // 2, :w // 2] = [1, 0, 0]
    img[:, :h // 2, w // 2:] = [0, 1, 0]
    img[:, h // 2:, :w // 2] = [0, 0, 1]
    img[:, h // 2:, w // 2:] = [1, 1, 0]
    noise = rng.rand(B, h, w, 3).astype(np.float32) * 0.05
    return torch.from_numpy(np.clip(img + noise, 0, 1))


def noise(B, h, w, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(B, h, w, 3).astype(np.float32))


# (2, 33, 47) and (3, 70, 45) have ragged tiles: the kernel's tiles are
# 32 columns by 64 rows (70 = 64 + 6 rows, 45 = 32 + 13 columns)
CASES = [(3, 64, 64, 9, 30.0), (2, 33, 47, 7, 20.0), (3, 70, 45, 12, 30.0),
         (5, 128, 96, 36, 50.0), (1, 40, 52, 128, 10.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("frames", ["quadrants", "noise"])
@pytest.mark.parametrize("B,h,w,K,comp", CASES)
def test_one_assignment_from_given_centers_on_card(B, h, w, K, comp, frames):
    """Centers of 4 plain rounds, then one assignment by each: >= 99.9%."""
    _need_card()
    x = (quadrants if frames == "quadrants" else noise)(B, h, w, seed=K).cuda()
    _, centers = slic(x, K, comp, n_iter=4, return_centers=True)
    want = slic(x, K, comp, n_iter=1, init_centers=centers)
    before = slic_fused.launches
    got = slic_fused(x, K, comp, n_iter=1, init_centers=centers)
    torch.cuda.synchronize()
    assert slic_fused.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (B, h, w)
    assert int(got.min()) >= 0 and int(got.max()) < K
    assert float((got == want).float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,w,K,comp", CASES[:4])
def test_full_run_on_structured_frames_on_card(B, h, w, K, comp):
    _need_card()
    x = quadrants(B, h, w, seed=1).cuda().reshape(1, B, h, w, 3)
    want = slic(x, K, comp)
    got = slic_fused(x, K, comp)
    assert got.shape == (1, B, h, w)
    assert float((got == want).float().mean()) >= 0.99


@pytest.mark.cuda
def test_centers_after_a_round_on_card():
    """The kernel's center means against the plain version's from the same
    start: 1e-3 of the features' scale (f32 sums in another order; a
    near-tie pixel moves a mean of ~450 members by less)."""
    _need_card()
    x = quadrants(2, 64, 64, seed=2).cuda()
    _, want = slic(x, 9, 30.0, n_iter=1, return_centers=True)
    _, got = slic_fused(x, 9, 30.0, n_iter=1, return_centers=True)
    assert got.shape == (2, 9, 5)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.cuda
def test_lab_and_no_lab_on_card():
    """One assignment from the grid centers (``n_iter=1``) exercises the
    kernel's Lab against ``rgb_to_lab`` and its ``100 * rgb`` path."""
    _need_card()
    x = noise(2, 40, 52, seed=3).cuda()
    for convert_lab in (True, False):
        kw = dict(n_iter=1, convert_lab=convert_lab)
        assert float((slic_fused(x, 12, 40.0, **kw) == slic(x, 12, 40.0, **kw))
                     .float().mean()) >= 0.999
    assert torch.isfinite(rgb_to_lab(x)).all()


@pytest.mark.cuda
def test_n_active_on_card():
    _need_card()
    x = quadrants(4, 64, 64, seed=4).cuda().reshape(2, 2, 64, 64, 3)
    na = torch.tensor([[9, 5], [3, 1]])
    got = slic_fused(x, 9, 30.0, n_active=na)
    want = slic(x, 9, 30.0, n_active=na.cuda())
    assert (got.reshape(4, -1).max(-1).values.cpu() < na.reshape(-1)).all()
    assert int(got[1, 1].max()) == 0
    assert float((got == want).float().mean()) >= 0.99


@pytest.mark.cuda
def test_two_runs_are_bitwise_equal_on_card():
    _need_card()
    for h, w in ((128, 128), (70, 45)):         # whole and ragged tiles
        x = noise(6, h, w, seed=5).cuda()
        a, ca = slic_fused(x, 36, 50.0, return_centers=True)
        b, cb = slic_fused(x, 36, 50.0, return_centers=True)
        assert torch.equal(a, b) and torch.equal(ca, cb)


@pytest.mark.cuda
def test_n_active_fallback_on_card():
    """1 or 2 active slots of 9: most pixels have no active center in their
    window and take the nearest active one (the fallback scan)."""
    _need_card()
    x = noise(4, 64, 64, seed=7).cuda()
    na = torch.tensor([1, 2, 1, 2], dtype=torch.int32, device="cuda")
    _, centers = slic(x, 9, 30.0, n_iter=3, n_active=na, return_centers=True)
    want = slic(x, 9, 30.0, n_iter=1, n_active=na, init_centers=centers)
    got = slic_fused(x, 9, 30.0, n_iter=1, n_active=na, init_centers=centers)
    assert float((got == want).float().mean()) >= 0.999
    full = slic_fused(x, 9, 30.0, n_active=na)
    assert int(full[0].max()) == 0 and int(full[2].max()) == 0
    assert int(full[1].max()) == 1 and int(full[3].max()) == 1
    assert float((full == slic(x, 9, 30.0, n_active=na)).float().mean()) >= 0.99


@pytest.mark.cuda
def test_return_centers_through_the_finalize_kernel_on_card():
    """The centers after the last round's update (the finalize kernel)
    are the means of the features of the kernel's own last labels (100 *
    rgb, exact on both sides) within 1e-4, and asking for them changes no
    label."""
    _need_card()
    B, h, w, K, comp = 3, 64, 64, 9, 30.0
    x = quadrants(B, h, w, seed=8).cuda()
    labels, centers = slic_fused(x, K, comp, n_iter=3, convert_lab=False,
                                 return_centers=True)
    assert torch.equal(labels, slic_fused(x, K, comp, n_iter=3,
                                          convert_lab=False))
    ratio, _ = slic_geometry(h, w, K, comp)
    yy, xx = torch.meshgrid(torch.arange(h, device="cuda"),
                            torch.arange(w, device="cuda"), indexing="ij")
    pos = torch.stack([yy.float() * ratio, xx.float() * ratio], -1)
    f5 = torch.cat([x * 100.0, pos.expand(B, -1, -1, -1)], -1)
    onehot = torch.nn.functional.one_hot(labels.long(), K).double()
    n = onehot.sum((1, 2))
    assert bool((n > 0).all())                    # no cluster came up empty
    want = torch.einsum("bhwk,bhwf->bkf", onehot, f5.double()) / n[..., None]
    assert float((centers.double() - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,K", [(64, 64, 9), (40, 52, 12), (33, 47, 7),
                                   (8, 8, 100)])
def test_grid_start_is_initial_centers_bitwise_on_card(h, w, K):
    """At ``n_iter=1`` the kernel starts from the grid it gathers itself:
    labels and centers equal, bit for bit, those of a start from
    ``initial_centers`` (100 * rgb features, the same on both sides)."""
    _need_card()
    x = noise(2, h, w, seed=K).cuda()
    kw = dict(n_iter=1, convert_lab=False, return_centers=True)
    ratio, _ = slic_geometry(h, w, K, 20.0)
    start = initial_centers((x * 100.0).reshape(2, h * w, 3), h, w, K, ratio)
    a, ca = slic_fused(x, K, 20.0, **kw)
    b, cb = slic_fused(x, K, 20.0, init_centers=start, **kw)
    assert torch.equal(a, b) and torch.equal(ca, cb)


@pytest.mark.cuda
def test_wrapper_refusals_on_card():
    _need_card()
    x = torch.zeros((2, 8, 8, 3), device="cuda")
    with pytest.raises(ValueError, match="at most 128 segments"):
        slic_fused(x, 129)
    with pytest.raises(ValueError, match="images must be"):
        slic_fused(x[..., :2])
    with pytest.raises(ValueError, match="floats"):
        slic_fused(x.to(torch.uint8))
    with pytest.raises(ValueError, match="init_centers"):
        slic_fused(x, 4, init_centers=torch.zeros((2, 4, 5)))   # on the CPU
    with pytest.raises(ValueError, match="n_active has 3"):
        slic_fused(x, 4, n_active=[1, 2, 3])


@pytest.mark.cuda
def test_kernel_raises_without_its_library(monkeypatch, tmp_path):
    """On a CUDA tensor: the kernels or an error, never the plain version."""
    _need_card()
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        slic_fused(torch.zeros((2, 8, 8, 3), device="cuda"), 4)
