"""The port's dilation (``videowalk_tpu_torch/ops/dilation.py`` on the CPU:
its plain version; ``models/crw.py::dilate_onehot``) against a brute-force
oracle and the JAX package (``ops/dilation_kernel.py`` in Pallas interpret
mode, ``models/crw.py::dilate_onehot``). Results are exact 0/1: equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videowalk_tpu.models.crw import dilate_onehot as jax_dilate_onehot
from videowalk_tpu.ops.dilation_kernel import dilate_l1_pallas
from videowalk_tpu_torch.models.crw import dilate_onehot
from videowalk_tpu_torch.ops.dilation import (SMEM_LIMIT, choose_band,
                                             dilate_l1, dilate_l1_plain,
                                             window_bytes)

torch.set_num_threads(1)


def l1_oracle(x: np.ndarray, r: int) -> np.ndarray:
    """out[n, y, x] = 1 iff a set pixel of mask n lies within L1 distance r."""
    N, h, w = x.shape
    ys, xs = np.mgrid[:h, :w]
    out = np.zeros_like(x)
    for n in range(N):
        for py, px in zip(*np.nonzero(x[n])):
            out[n][np.abs(ys - py) + np.abs(xs - px) <= r] = 1
    return out


def _masks(N, h, w, seed, density=0.01):
    rng = np.random.RandomState(seed)
    x = (rng.rand(N, h, w) < density).astype(np.float32)
    x[0] = 0
    x[0, 0, 0] = x[0, h - 1, w - 1] = 1          # corners: the frame's clipping
    return x


@pytest.mark.parametrize("k", [5, 7, 12, 23, 55])
def test_dilate_l1_equals_oracle_and_jax_kernel(k):
    x = _masks(3, 40, 52, seed=k)
    before = dilate_l1.launches
    got = dilate_l1(torch.from_numpy(x), k)
    assert dilate_l1.launches == before          # no kernel on the CPU
    assert got.dtype == torch.float32 and got.shape == (3, 40, 52)
    np.testing.assert_array_equal(got.numpy(), l1_oracle(x, k // 2))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(dilate_l1_pallas(jnp.asarray(x), k,
                                                 interpret=True)))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16, torch.float32])
def test_dilate_l1_keeps_the_input_type(dtype):
    x = _masks(2, 33, 47, seed=1)
    got = dilate_l1(torch.from_numpy(x).to(dtype), 9)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), l1_oracle(x, 4))


def test_dilate_l1_refusals():
    x = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="radius 1"):
        dilate_l1(x, 3)
    with pytest.raises(ValueError, match="radius 128"):
        dilate_l1(x, 257)
    with pytest.raises(ValueError, match=r"\(N, h, w\)"):
        dilate_l1(torch.zeros((2, 2, 8, 8)), 5)
    with pytest.raises(ValueError, match="uint8, bfloat16 or float32"):
        dilate_l1(x.to(torch.int32), 5)
    with pytest.raises(ValueError, match="unsupported device"):
        dilate_l1(torch.zeros((2, 8, 8), device="meta"), 5)
    assert torch.equal(dilate_l1_plain(x, 1), x)


@pytest.mark.parametrize("shape", ["L1", "cross", "circle"])
@pytest.mark.parametrize("k", [1, 3, 7, 13])
def test_dilate_onehot_equals_jax(k, shape):
    x = _masks(4, 24, 20, seed=k, density=0.02).reshape(2, 2, 24, 20)
    want = np.asarray(jax_dilate_onehot(jnp.asarray(x), k, shape))
    got = dilate_onehot(torch.from_numpy(x), k, shape)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    bf = dilate_onehot(torch.from_numpy(x).bfloat16(), k, shape)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(), want)


def test_dilate_onehot_has_no_gradient_and_refuses_unknown_shapes():
    x = torch.zeros((1, 8, 8), requires_grad=True)
    assert not dilate_onehot(x, 5, "L1").requires_grad
    with pytest.raises(ValueError, match="unknown dilation kernel shape"):
        dilate_onehot(x, 5, "square")


# A bit-packed model of the CUDA kernel (``ops/csrc/dilation.cu``), which
# cannot run here: rows packed into 32-bit words, one (mask, band of whole
# rows) at a time with its window of r rows above and below clipped at the
# frame, passes of the radius-K diamond (K = KMAX, the last pass what is
# left) over two buffers in turn, each pass over the rows within r - (the
# radius done) of the band and within that radius of the window's set rows
# only, the other rows read as zeros (bits past the width are left to fill,
# as in the kernel), then the band's rows unpacked. The second buffer starts
# as all ones, as uninitialised shared memory may: a pass that read a row no
# earlier pass wrote would show.

KMAX = 4


def _pack(bits: np.ndarray) -> np.ndarray:
    R, w = bits.shape
    ww = (w + 31) // 32
    padded = np.zeros((R, ww * 32), np.uint64)
    padded[:, :w] = bits
    return (padded.reshape(R, ww, 32) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)


def _unpack(words: np.ndarray, w: int) -> np.ndarray:
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(words.shape[0], -1)[:, :w]


def _spread(rows: np.ndarray, m: int) -> np.ndarray:
    """Each row's bits spread along the row by m, carried across words (the
    kernel's funnel shifts)."""
    c = rows.astype(np.uint64)
    zero = np.zeros_like(c[:, :1])
    left = np.concatenate([zero, c[:, :-1]], 1)
    right = np.concatenate([c[:, 1:], zero], 1)
    out = c.copy()
    for t in range(1, m + 1):
        out |= ((c << t) | (left >> (32 - t))) & 0xffffffff
        out |= (c >> t) | ((right << (32 - t)) & 0xffffffff)
    return out.astype(np.uint32)


def _diamond_pass(src, dst, lo, hi, rlo, rhi, k):
    """Rows [lo, hi) of dst; the rows of src outside [rlo, rhi) read as
    zeros."""
    new = np.zeros_like(src[lo:hi])
    for dy in range(-k, k + 1):
        a, b = max(rlo, lo + dy), min(rhi, hi + dy)     # rows read
        if a < b:
            new[a - dy - lo:b - dy - lo] |= _spread(src[a:b], k - abs(dy))
    dst[lo:hi] = new


def bit_model(x: np.ndarray, r: int, band: int, kmax: int = KMAX) -> np.ndarray:
    N, h, w = x.shape
    out = np.zeros_like(x)
    for n in range(N):
        for y0 in range(0, h, band):
            y1 = min(h, y0 + band)
            wy0 = max(0, y0 - r)
            buf = [_pack(x[n, wy0:min(h, y1 + r)] != 0), None]
            buf[1] = np.full_like(buf[0], 0xffffffff)
            R = buf[0].shape[0]
            set_rows = np.nonzero(buf[0].any(1))[0]
            if not len(set_rows):
                continue                                 # written as zeros
            top, bot = set_rows[0], set_rows[-1]
            done = p = 0
            while done < r:
                k = min(kmax, r - done)
                rlo, rhi = max(0, top - done), min(R, bot + done + 1)
                done += k
                lo = max(0, y0 - (r - done) - wy0, top - done)
                hi = min(R, y1 + (r - done) - wy0, bot + done + 1)
                if lo < hi:
                    _diamond_pass(buf[p & 1], buf[(p + 1) & 1], lo, hi, rlo,
                                  rhi, k)
                p += 1
            # the band's rows within r of the set rows; zeros elsewhere
            a, b = max(y0, wy0 + top - r), min(y1, wy0 + bot + r + 1)
            if a < b:
                out[n, a:b] = _unpack(buf[p & 1][a - wy0:b - wy0], w)
    return out


def _hold_model(x: np.ndarray, r: int, band: int, kmax: int = KMAX) -> None:
    want = l1_oracle(x, r)
    np.testing.assert_array_equal(bit_model(x, r, band, kmax), want)
    np.testing.assert_array_equal(
        dilate_l1_plain(torch.from_numpy(x), 2 * r + 1).numpy(), want)


@pytest.mark.parametrize("h,w,r,band", [
    (40, 52, 5, 16), (40, 52, 2, 40), (33, 17, 3, 7), (50, 65, 12, 50),
    (64, 33, 12, 64), (70, 96, 27, 25), (129, 70, 27, 50), (100, 60, 127, 7),
    (60, 31, 127, 60)])
def test_bit_model_equals_oracle_and_plain(h, w, r, band):
    """Widths under 32, 32k + 1 and otherwise ragged, bands that do not
    divide h, radii from 2 to 127, corners set in mask 0."""
    _hold_model(_masks(3, h, w, seed=h + w + r, density=0.01), r, band)


@pytest.mark.parametrize("band", [256, 128])
def test_bit_model_at_the_step_of_record(band):
    """256x256 at r=27: the whole frame as one band, and half frames."""
    _hold_model(_masks(2, 256, 256, seed=band, density=0.0003), 27, band)


@pytest.mark.parametrize("kmax", [1, 2, 3, 4])
@pytest.mark.parametrize("r", [2, 27])
def test_bit_model_with_set_pixels_in_a_halo_only(r, kmax):
    """A band whose own rows are empty but whose halo rows are not: its
    window is not empty, and its output comes from the neighbours' rows."""
    h, w, band = 3 * 20 + 7, 45, 20
    x = np.zeros((2, h, w), np.float32)
    x[0, band - 1, 3] = x[0, 2 * band + r - 1, w - 1] = 1   # mask 0: halo rows
    x[1, band - r, 0] = x[1, 2 * band, 44] = 1              # the halo's edges
    _hold_model(x, r, band, kmax)
    assert bit_model(x, r, band, kmax)[:, band:2 * band].any()


@pytest.mark.parametrize("kmax", [1, 2, 3, 4])
def test_bit_model_at_the_frame_corners(kmax):
    x = np.zeros((1, 37, 41), np.float32)
    x[0, 0, 0] = x[0, 0, 40] = x[0, 36, 0] = x[0, 36, 40] = 1
    for band in (37, 10, 1):
        _hold_model(x, 2, band, kmax)
        _hold_model(x, 27, band, kmax)


def test_window_bytes_and_the_band_the_wrapper_chooses():
    """The default band at the step of record is the whole frame (two
    buffers of 256 rows of 9 words and the 64-byte set-row reduction: 18
    KB); a frame whose window does not fit the card takes the tallest band
    that does, the reduction's bytes counted: at (2048, 512, r 27) a band of
    1654 rows leaves them room, 1655 would not."""
    assert window_bytes(256, 256, 27, 256) == 2 * 256 * 9 * 4 + 64
    assert choose_band(256, 256, 27) == 256
    assert choose_band(1024, 512, 27) == 1024            # 139 KB
    for h, w in ((2048, 1024), (2048, 512)):
        band = choose_band(h, w, 27)
        assert band < h
        assert window_bytes(h, w, 27, band) <= SMEM_LIMIT
        assert window_bytes(h, w, 27, band + 1) > SMEM_LIMIT
    assert choose_band(2048, 512, 27) == 1654


def test_choose_band_refuses_a_width_that_does_not_fit_the_kernel():
    """At r=127 a band of one row has a window of 255 rows: 113 words a row
    (3616 pixels) fit the 227 KB of shared memory with the reduction's 64
    bytes, 114 do not. The limit is the card kernel's: a CPU tensor of any
    width takes the plain version."""
    assert window_bytes(255, 3616, 127, 1) <= SMEM_LIMIT
    assert window_bytes(255, 3617, 127, 1) > SMEM_LIMIT
    assert choose_band(255, 3616, 127) >= 1
    with pytest.raises(ValueError,
                       match=r"width 3617 .*\(widths up to 3616\)"):
        choose_band(255, 3617, 127)
    for w in (3616, 3617):
        x = torch.zeros((1, 8, w))
        x[0, 3, 3000] = 1
        np.testing.assert_array_equal(dilate_l1(x, 255).numpy(),
                                      l1_oracle(x.numpy(), 127))
