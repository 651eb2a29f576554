"""The L1 dilation CUDA kernel (``videowalk_tpu_torch/ops/csrc/dilation.cu``)
against its plain version on the card (``-m cuda``; skipped where there is
no card). The result is exact 0/1: equality. No JAX here, so the file runs
with ``--noconftest`` where JAX is not installed."""

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.ops import _build
from videowalk_tpu_torch.ops.dilation import dilate_l1, dilate_l1_plain

DTYPES = {"uint8": torch.uint8, "bfloat16": torch.bfloat16,
          "float32": torch.float32}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _masks(N, h, w, seed, density):
    rng = np.random.RandomState(seed)
    x = (rng.rand(N, h, w) < density).astype(np.float32)
    x[0] = 0                                    # an empty mask
    if N > 1:
        x[1] = 0
        x[1, 0, 0] = x[1, h - 1, w - 1] = 1     # corners: the frame's clipping
    return torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N,h,w,k,density", [
    (3, 40, 52, 5, 0.01), (3, 33, 47, 7, 0.01), (5, 40, 52, 12, 0.005),
    (7, 64, 64, 23, 0.002), (2, 129, 70, 55, 0.001), (11, 256, 256, 55, 0.0003),
    (1, 65, 130, 9, 0.3), (2, 100, 60, 255, 0.0005)])
def test_kernel_equals_plain_on_card(N, h, w, k, density, dtype):
    """Small, ragged and tile-crossing shapes (tiles are 64x64), radii from 2
    to the largest taken (127), sparse and dense masks, N a multiple of
    nothing."""
    _need_card()
    x = _masks(N, h, w, seed=k + h, density=density).to(DTYPES[dtype]).cuda()
    before = dilate_l1.launches
    got = dilate_l1(x, k)
    torch.cuda.synchronize()
    assert dilate_l1.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    want = dilate_l1_plain(x.float(), k)
    assert torch.equal(got.float(), want)
    assert float(got[0].float().abs().max()) == 0.0


@pytest.mark.cuda
def test_kernel_takes_a_misaligned_view_on_card():
    """A stack that starts 2 bytes into its storage: the four-pixel stores
    are off, the scalar ones must give the same result."""
    _need_card()
    base = _masks(4, 40, 52, seed=2, density=0.01).to(torch.bfloat16).cuda()
    flat = torch.zeros(base.numel() + 1, dtype=torch.bfloat16, device="cuda")
    flat[1:] = base.reshape(-1)
    x = flat[1:].view(4, 40, 52)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    assert torch.equal(dilate_l1(x, 9), dilate_l1(base, 9))
    assert torch.equal(dilate_l1(base, 9).float(),
                       dilate_l1_plain(base.float(), 9))


@pytest.mark.cuda
def test_kernel_raises_without_its_library(monkeypatch, tmp_path):
    """On a CUDA tensor: the kernel or an error, never the plain version."""
    _need_card()
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        dilate_l1(torch.zeros((2, 8, 8), device="cuda"), 5)


@pytest.mark.cuda
def test_wrapper_refusals_on_card():
    _need_card()
    x = torch.zeros((2, 8, 8), device="cuda")
    with pytest.raises(ValueError, match="radius 1"):
        dilate_l1(x, 3)
    with pytest.raises(ValueError, match=r"\(N, h, w\)"):
        dilate_l1(x[None], 5)
    with pytest.raises(ValueError, match="uint8, bfloat16 or float32"):
        dilate_l1(x.half(), 5)
