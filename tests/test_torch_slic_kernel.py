"""The fused SLIC CUDA kernels (``videowalk_tpu_torch/ops/csrc/slic.cu``)
against their plain version ``ops/slic_device.py::slic`` on the card
(``-m cuda``; skipped where there is no card). No JAX here, so the file
runs with ``--noconftest`` where JAX is not installed.

The kernel takes the direct ``sum (f - c)^2``, the plain version the
expanded form, whose f32 rounding decides near-ties, and k-means carries a
differing pixel through its rounds. So: one assignment from the same
centers >= 99.9% equal labels on any input; a full run on structured frames
>= 99%; two runs of the kernel bitwise equal."""

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.ops import _build
from videowalk_tpu_torch.ops.slic import slic_fused
from videowalk_tpu_torch.ops.slic_device import rgb_to_lab, slic


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


CASES = [(3, 64, 64, 9, 30.0), (2, 33, 47, 7, 20.0), (5, 128, 96, 36, 50.0),
         (1, 40, 52, 128, 10.0)]


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
@pytest.mark.parametrize("B,h,w,K,comp", CASES[:3])
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
    x = noise(6, 128, 128, seed=5).cuda()
    a, ca = slic_fused(x, 36, 50.0, return_centers=True)
    b, cb = slic_fused(x, 36, 50.0, return_centers=True)
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
