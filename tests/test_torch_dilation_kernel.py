"""The L1 dilation CUDA kernel (``videowalk_tpu_torch/ops/csrc/dilation.cu``)
against its plain version on the card (``-m cuda``; skipped where there is
no card). The result is exact 0/1: equality. No JAX here, so the file runs
with ``--noconftest`` where JAX is not installed."""

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.ops import _build
from videowalk_tpu_torch.ops.dilation import (_DTYPES, _lib, choose_band,
                                             dilate_l1, dilate_l1_plain,
                                             window_bytes)

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
    """Small and ragged shapes, radii from 2 to the largest taken
    (127), sparse and dense masks, N a multiple of nothing."""
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
@pytest.mark.parametrize("h,w", [(300, 70), (600, 3000)])
def test_kernel_at_band_edges_at_the_largest_radius_on_card(h, w):
    """One set pixel at the first and one at the last row of a band, r=127,
    widths that are no multiple of 32: a whole frame (300x70, rows 0 and
    299), and 51-row bands of a frame too wide for one (600x3000, 12
    bands). The halo carries the pixels into every band they reach."""
    _need_card()
    band = choose_band(h, w, 127)
    assert band == (h if w == 70 else 51)
    first, last = (band, 2 * band - 1) if band < h else (0, h - 1)
    x = torch.zeros((3, h, w), dtype=torch.bfloat16)
    x[0, first, 0] = x[1, last, w - 1] = 1
    x[2, first, 33] = x[2, last, 34] = 1
    x = x.cuda()
    before = dilate_l1.launches
    got = dilate_l1(x, 255)
    torch.cuda.synchronize()
    assert dilate_l1.launches == before + 1
    assert torch.equal(got.float(), dilate_l1_plain(x.float(), 255))


@pytest.mark.cuda
@pytest.mark.parametrize("N,h,w,bands", [
    (11, 256, 256, 1), (2, 2048, 1024, 3), (2, 2048, 512, 2),
    (2, 64, 16650, 64)])
def test_kernel_in_bands_at_the_step_of_record_on_card(N, h, w, bands):
    """The step's radius (k=55): its whole 256x256 frame; frames whose
    window does not fit in 826- and 1654-row bands (the latter's window 96
    bytes under the limit, the set-row reduction counted); and a frame so
    wide that a band is one row."""
    _need_card()
    assert -(-h // choose_band(h, w, 27)) == bands
    x = _masks(N, h, w, seed=3, density=0.0003).to(torch.bfloat16).cuda()
    got = dilate_l1(x, 55)
    assert torch.equal(got.float(), dilate_l1_plain(x.float(), 55))


@pytest.mark.cuda
@pytest.mark.parametrize("N,h,w,k", [(3, 1024, 512, 55), (3, 255, 3616, 255)])
def test_kernel_with_more_than_48_kb_of_shared_memory_on_card(N, h, w, k):
    """Whole frames whose window takes 139 KB, and the widest frame the
    kernel takes at r=127 (225 KB, one block an SM)."""
    _need_card()
    x = _masks(N, h, w, seed=w, density=0.0002).to(torch.bfloat16).cuda()
    assert window_bytes(h, w, k // 2, choose_band(h, w, k // 2)) > 48 * 1024
    got = dilate_l1(x, k)
    assert torch.equal(got.float(), dilate_l1_plain(x.float(), k))


@pytest.mark.cuda
def test_kernel_refuses_a_width_that_does_not_fit_on_card():
    """One pixel wider than the widest frame at r=127: the wrapper raises
    with the limit and never falls back to the plain version."""
    _need_card()
    x = torch.zeros((1, 255, 3617), device="cuda")
    before = dilate_l1.launches
    with pytest.raises(ValueError, match=r"\(widths up to 3616\)"):
        dilate_l1(x, 255)
    assert dilate_l1.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_writes_zeros_for_an_empty_stack_on_card(dtype):
    """Every window empty: the kernel writes every pixel of an output that
    holds ones before the launch (the C entry, given that output)."""
    _need_card()
    x = torch.zeros((6, 256, 256), dtype=DTYPES[dtype], device="cuda")
    out = torch.ones_like(x)
    err = _lib().dilate_l1_launch(
        x.data_ptr(), out.data_ptr(), 6, 256, 256, 27, _DTYPES[x.dtype],
        choose_band(256, 256, 27), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert float(out.float().abs().max()) == 0.0
    got = dilate_l1(x, 55)
    assert got.dtype == x.dtype and float(got.float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,w", [("uint8", 52), ("float32", 50),
                                     ("bfloat16", 52)])
def test_kernel_takes_the_scalar_path_on_card(dtype, w):
    """Rows that are no multiple of the 16-byte vector (16 uint8, 4 f32,
    8 bf16): one pixel a lane, a ballot a word."""
    _need_card()
    x = _masks(4, 45, w, seed=w, density=0.01).to(DTYPES[dtype]).cuda()
    got = dilate_l1(x, 11)
    assert got.dtype == x.dtype
    assert torch.equal(got.float(), dilate_l1_plain(x.float(), 11))


@pytest.mark.cuda
def test_kernel_takes_a_misaligned_view_on_card():
    """A stack that starts 2 bytes into its storage: the 16-byte loads and
    stores are off, the scalar ones must give the same result."""
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
