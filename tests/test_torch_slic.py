"""The port's plain SLIC (``videowalk_tpu_torch/ops/slic_device.py``) and
its fused wrapper on the CPU (``ops/slic.py``, which takes the plain version
there) against the JAX package's ``ops/slic_device.py`` and
``ops/slic_kernel.py`` (Pallas, interpret mode off the TPU).

Tolerances: Lab atol 2e-3 on values up to 100 (``** 2.4`` and the cube root
differ in their last bits between XLA and PyTorch); grid centers equal
(numpy on both sides); labels >= 99% equal on structured frames (the JAX
package's own limit between its two implementations: f32 near-ties, carried
through the k-means rounds).

Rounds: the port's ``slic`` and ``slic_fused`` follow the JAX ``slic`` (the
backend that training deploys): ``n_iter`` assignments with ``n_iter - 1``
center updates between them. The Pallas body behind the JAX ``slic_fused``
updates after every one of its ``n_iter`` assignments and assigns once more,
so it is the port at ``n_iter + 1``;
``test_slic_fused_rounds_follow_slic_not_the_pallas_body`` holds both sides of
that on frames that have not converged."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videowalk_tpu.ops import slic_device as jsd
from videowalk_tpu.ops.slic_kernel import slic_fused as jax_slic_fused
from videowalk_tpu_torch.ops import slic_device as tsd
from videowalk_tpu_torch.ops.slic import slic_fused

torch.set_num_threads(1)


def quadrant(h=64, w=64, seed=0):
    """Four colored quadrants plus 5% noise (tests/test_slic_kernel.py)."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[:h // 2, :w // 2] = [1, 0, 0]
    img[:h // 2, w // 2:] = [0, 1, 0]
    img[h // 2:, :w // 2] = [0, 0, 1]
    img[h // 2:, w // 2:] = [1, 1, 0]
    return np.clip(img + rng.rand(h, w, 3).astype(np.float32) * 0.05, 0, 1)


def _frames():
    return np.stack([quadrant(seed=i) for i in range(4)]).reshape(
        2, 2, 64, 64, 3)


def test_rgb_to_lab_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(5, 7, 3).astype(np.float32)
    x[0, 0] = [0, 0, 0]                     # the linear branches
    x[0, 1] = [1, 1, 1]
    x[0, 2] = [0.03, 0.001, 0.04]
    x[0, 3] = [-0.5, 1.5, 0.5]              # clipped
    got = tsd.rgb_to_lab(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsd.rgb_to_lab(jnp.asarray(x))),
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(got[0, 1], [100.0, 0.0, 0.0], atol=2e-2)


@pytest.mark.parametrize("H,W,n", [(64, 64, 9), (256, 256, 36), (40, 52, 12),
                                   (33, 47, 7), (16, 64, 5), (8, 8, 100)])
def test_grid_centers_equal_jax(H, W, n):
    cy, cx = tsd._grid_centers(H, W, n)
    jy, jx = jsd._grid_centers(H, W, n)
    assert cy.shape == (n,) and cy.dtype == np.float32
    np.testing.assert_array_equal(cy, np.asarray(jy))
    np.testing.assert_array_equal(cx, np.asarray(jx))


@pytest.mark.parametrize("n_active", [None, [[9, 5], [7, 3]]])
def test_slic_matches_jax_slic(n_active):
    x = _frames()
    ja = None if n_active is None else jnp.asarray(n_active)
    want = np.asarray(jsd.slic(jnp.asarray(x), 9, 30.0, n_active=ja))
    got = tsd.slic(torch.from_numpy(x), 9, 30.0, n_active=n_active)
    assert got.shape == (2, 2, 64, 64) and got.dtype == torch.int32
    got = got.numpy()
    assert (got == want).mean() >= 0.99
    assert got.min() >= 0 and got.max() <= 8
    if n_active is not None:
        na = np.asarray(n_active)
        assert (got.reshape(2, 2, -1).max(-1) < na).all()
        assert len(np.unique(got[1, 1])) <= 3


def test_slic_fused_on_cpu_matches_jax_slic_fused():
    """The wrapper takes the plain version for a CPU tensor; the JAX side
    runs its Pallas kernel in interpret mode (which assigns once more after
    its last update: on these frames both have converged)."""
    x = _frames()[0]
    want = np.asarray(jax_slic_fused(jnp.asarray(x), 9, 30.0))
    before = slic_fused.launches
    got = slic_fused(torch.from_numpy(x), 9, 30.0)
    assert slic_fused.launches == before        # no kernel on the CPU
    assert got.dtype == torch.int32 and got.shape == (2, 64, 64)
    assert (got.numpy() == want).mean() >= 0.99


def unconverged(seed, h=64, w=64):
    """Two frames of smooth color waves and off-grid rectangles plus 5%
    noise: the centers still move after a few rounds."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    out = []
    for _ in range(2):
        img = np.zeros((h, w, 3), np.float32)
        for c in range(3):
            fy, fx, ph = rng.uniform(0.05, 0.2, 3)
            img[..., c] = 0.5 + 0.5 * np.sin(fy * yy + fx * xx * (1 + c)
                                             + ph * 10)
        for _ in range(4):
            y0, x0 = rng.randint(0, 48, 2)
            img[y0:y0 + rng.randint(8, 24), x0:x0 + rng.randint(8, 24)] = \
                rng.rand(3)
        out.append(np.clip(img + rng.rand(h, w, 3).astype(np.float32) * 0.05,
                           0, 1))
    return np.stack(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_slic_fused_rounds_follow_slic_not_the_pallas_body(seed):
    """The port at ``n_iter`` is the JAX ``slic`` at ``n_iter`` and the JAX
    ``slic_fused`` at ``n_iter - 1`` (>= 99% equal labels each), and on these
    frames it is not the JAX ``slic_fused`` at ``n_iter`` (its extra update
    and assignment move several percent of the pixels)."""
    x = unconverged(seed)
    got = slic_fused(torch.from_numpy(x), 9, 30.0, n_iter=3).numpy()
    xj = jnp.asarray(x)
    assert (got == np.asarray(jsd.slic(xj, 9, 30.0, n_iter=3))).mean() >= 0.99
    assert (got == np.asarray(jax_slic_fused(xj, 9, 30.0, n_iter=2))).mean() \
        >= 0.99
    assert (got == np.asarray(jax_slic_fused(xj, 9, 30.0, n_iter=3))).mean() \
        < 0.97


def test_one_assignment_from_given_centers():
    """``n_iter`` rounds equal ``n_iter - 1`` rounds' centers followed by one
    assignment from them (``init_centers``, ``n_iter=1``)."""
    x = torch.from_numpy(_frames())
    full = tsd.slic(x, 9, 30.0, n_iter=4)
    _, centers = tsd.slic(x, 9, 30.0, n_iter=3, return_centers=True)
    assert centers.shape == (4, 9, 5)
    again = tsd.slic(x, 9, 30.0, n_iter=1, init_centers=centers)
    assert torch.equal(full, again)


def test_no_lab_and_ragged_frames():
    """``convert_lab=False`` and a frame whose HW is no multiple of 128
    (the JAX kernel needs one; ``slic`` does not)."""
    rng = np.random.RandomState(3)
    x = rng.rand(2, 33, 47, 3).astype(np.float32)
    want = np.asarray(jsd.slic(jnp.asarray(x), 7, 20.0, convert_lab=False))
    got = tsd.slic(torch.from_numpy(x), 7, 20.0, convert_lab=False).numpy()
    assert got.shape == (2, 33, 47)
    assert (got == want).mean() >= 0.99


def test_slic_refuses_bad_arguments():
    x = torch.zeros((2, 8, 8, 3))
    with pytest.raises(ValueError, match="images must be"):
        tsd.slic(torch.zeros((2, 8, 8, 4)))
    with pytest.raises(ValueError, match="floats"):
        tsd.slic(torch.zeros((2, 8, 8, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="n_active has 3"):
        tsd.slic(x, 4, n_active=[1, 2, 3])
    with pytest.raises(ValueError, match="init_centers"):
        tsd.slic(x, 4, init_centers=torch.zeros((2, 5, 5)))
    with pytest.raises(ValueError, match="unsupported device"):
        slic_fused(torch.zeros((2, 8, 8, 3), device="meta"))


# --- the algebra of the fused kernel's design (ops/csrc/slic.cu), in plain
# torch: a per-tile window cull and fixed-point center sums. The kernels run
# only on the card; these mirrors hold what they compute to the plain version.

WARP_ROWS = 8                         # a thread's rows (one column)
TILE_W, TILE_H = 32, 8 * WARP_ROWS    # the round kernel's tile: 8 warps


def _features(x, n_segments, compactness):
    """``(B, HW, 5)`` features of ``x (B, H, W, 3)`` and ``(ratio, window)``,
    as the plain version builds them."""
    B, H, W, _ = x.shape
    ratio, window = tsd.slic_geometry(H, W, n_segments, compactness)
    color = tsd.rgb_to_lab(x).reshape(B, H * W, 3)
    py = torch.arange(H, dtype=torch.float32)[:, None].expand(H, W) * ratio
    px = torch.arange(W, dtype=torch.float32)[None, :].expand(H, W) * ratio
    coords = torch.stack([py.reshape(-1), px.reshape(-1)], -1)
    return torch.cat([color, coords.expand(B, -1, -1)], -1), ratio, window


def _direct(f5, c):
    """``(B, HW, K)`` direct-form squared distances and the window's
    ``|dy|``, ``|dx|``."""
    diff = f5[:, :, None, :] - c[:, None, :, :]
    sq = diff * diff
    d = sq[..., 0] + sq[..., 1] + sq[..., 2] + sq[..., 3] + sq[..., 4]
    return d, diff[..., 3].abs(), diff[..., 4].abs()


def _active(kact, K):
    return torch.arange(K)[None, :] < torch.as_tensor(kact)[:, None]  # (B, K)


def _dense_labels(f5, c, kact, window):
    """The uncut scan: the nearest in-window active center, else the
    nearest active one; ties to the lowest slot."""
    d, ady, adx = _direct(f5, c)
    act = _active(kact, c.shape[1])[:, None, :]
    inf = torch.tensor(float("inf"))
    win = ~((ady > window) | (adx > window)) & act
    has = win.any(-1)
    return torch.where(has, torch.where(win, d, inf).argmin(-1),
                       torch.where(act, d, inf).argmin(-1))


def _tile_lists(c, kact, H, W, ratio, window):
    """``(B, tiles, K)`` the slots the kernel lists for each tile, and
    ``(B, tiles, 8, K)`` those each warp's rows keep: the active ones whose
    center lies within the window, plus a margin, of the tile's (the
    warp's) edge pixels, every f32 product as the kernel's."""
    f32 = np.float32
    r, w = f32(ratio), f32(window)
    ys = np.arange(0, H, TILE_H)
    xs = np.arange(0, W, TILE_W)
    reach = w + f32(1e-4) * (f32(1.0) + w + f32(H - 1) * r + f32(W - 1) * r)
    ylo = ys.astype(f32) * r - reach
    yhi = (np.minimum(ys + TILE_H, H) - 1).astype(f32) * r + reach
    xlo = xs.astype(f32) * r - reach
    xhi = (np.minimum(xs + TILE_W, W) - 1).astype(f32) * r + reach
    yw = ys[:, None] + np.arange(8)[None, :] * WARP_ROWS          # (ty, 8)
    wlo = yw.astype(f32) * r - reach
    whi = (yw + WARP_ROWS - 1).astype(f32) * r + reach
    n_t = len(ys) * len(xs)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ylo, yhi = (t(np.repeat(v, len(xs))).reshape(1, n_t, 1) for v in (ylo, yhi))
    xlo, xhi = (t(np.tile(v, len(ys))).reshape(1, n_t, 1) for v in (xlo, xhi))
    wlo, whi = (t(np.repeat(v, len(xs), 0)).reshape(1, n_t, 8, 1)
                for v in (wlo, whi))
    cy, cx = c[:, None, :, 3], c[:, None, :, 4]
    listed = ((cy >= ylo) & (cy <= yhi) & (cx >= xlo) & (cx <= xhi)
              & _active(kact, c.shape[1])[:, None, :])
    kept = listed[:, :, None, :] & (cy[:, :, None] >= wlo) & (cy[:, :, None] <= whi)
    return listed, kept


def _pixel_tiles(H, W):
    """Each pixel's tile and warp (its rows within the tile)."""
    yy, xx = np.mgrid[:H, :W]
    tile = (yy // TILE_H) * ((W + TILE_W - 1) // TILE_W) + xx // TILE_W
    return (torch.from_numpy(tile.reshape(-1)),
            torch.from_numpy(((yy % TILE_H) // WARP_ROWS).reshape(-1)))


def _culled_labels(f5, c, kact, H, W, ratio, window):
    """The kernel's assignment: the exact per-pixel window test over the
    slots its warp keeps of its tile's list; a pixel with no kept slot in
    its window scans every active slot. Also returns the tile lists, which
    pixels fell back, and the in-window active slots a pixel's warp did not
    keep (there must be none)."""
    listed, kept = _tile_lists(c, kact, H, W, ratio, window)
    tile, warp = _pixel_tiles(H, W)
    keep = kept[:, tile, warp, :]                             # (B, HW, K)
    d, ady, adx = _direct(f5, c)
    inf = torch.tensor(float("inf"))
    act = _active(kact, c.shape[1])[:, None, :]
    in_window = ~((ady > window) | (adx > window)) & act
    win = in_window & keep
    has = win.any(-1)
    labels = torch.where(has, torch.where(win, d, inf).argmin(-1),
                         torch.where(act, d, inf).argmin(-1))
    return labels, listed, ~has, in_window & ~keep


def _grid_start(x, n_segments, compactness):
    B, H, W, _ = x.shape
    f5, ratio, window = _features(x, n_segments, compactness)
    c = tsd.initial_centers(f5[..., :3].contiguous(), H, W, n_segments, ratio)
    return f5, c, ratio, window


@pytest.mark.parametrize("H,W,K,comp,kact", [
    (33, 47, 7, 20.0, [7, 4]),          # tiles that do not divide H or W
    (70, 45, 12, 30.0, [12, 1]),        # n_active down to 1: the fallback
    (64, 64, 9, 30.0, [2, 1]),
    (256, 256, 36, 50.0, [36, 30]),     # the step of record's geometry
])
def test_window_cull_gives_the_uncut_labels(H, W, K, comp, kact):
    """Per-tile conservative lists with the exact per-pixel window test and
    the fallback scan equal the uncut direct-form scan, label for label, at
    the grid start and after three plain rounds; no in-window active center
    is ever left off its tile's list."""
    rng = np.random.RandomState(H + K)
    x = torch.from_numpy(rng.rand(2, H, W, 3).astype(np.float32))
    f5, c0, ratio, window = _grid_start(x, K, comp)
    _, c3 = tsd.slic(x, K, comp, n_iter=3, n_active=kact, return_centers=True)
    fell_back = 0
    for c in (c0, c3):
        got, lists, fallback, missed = _culled_labels(f5, c, kact, H, W,
                                                      ratio, window)
        assert not missed.any()
        assert torch.equal(got, _dense_labels(f5, c, kact, window))
        assert (got < torch.as_tensor(kact)[:, None]).all()
        fell_back += int(fallback.sum())
    if min(kact) <= 2:
        assert fell_back > 0                 # the fallback was exercised
    if H == 256:
        # ~19 of 36 slots listed a 32x64 tile at the step of record
        assert 8 <= float(lists[0].sum(-1).float().mean()) <= 24


def _fixed_point_means(f5, labels, prev, kact, H, W):
    """The kernel's update: each warp's (8 rows x 32 columns of a tile) f32
    partial sums per label, a block's 8 warps summed in order, int64 fixed
    point (round(sum * 2^20); the count as it is) over the blocks, mean =
    f32(f64(S) * 2^-20 / n); an empty or inactive slot keeps its center."""
    B, HW, _ = f5.shape
    K = prev.shape[1]
    tile, warp = _pixel_tiles(H, W)
    n_tiles = int(tile.max()) + 1
    vals = torch.cat([f5, torch.ones(B, HW, 1)], -1)          # (B, HW, 6)
    slot = (tile * 8 + warp)[None, :] * K + labels            # (B, HW)
    part = torch.zeros(B, n_tiles * 8 * K, 6)
    for b in range(B):
        part[b].index_add_(0, slot[b], vals[b])
    part = part.reshape(B, n_tiles, 8, K, 6)
    block = part[:, :, 0]
    for w in range(1, 8):                                     # warps in order
        block = block + part[:, :, w]
    q = torch.round(block.double() * 2.0 ** 20).long()
    q[..., 5] = block[..., 5].long()                          # the count
    S = q.sum(1)                                              # (B, K, 6) int64
    n = S[..., 5:6]
    mean = (S[..., :5].double() * 2.0 ** -20 / n.clamp_min(1).double()).float()
    keep = (n == 0) | ~_active(kact, K)[..., None]
    return torch.where(keep, prev, mean)


@pytest.mark.parametrize("H,W,K,comp,kact", [
    (33, 47, 7, 20.0, [7, 4]),
    (256, 256, 36, 50.0, [36, 36]),
])
def test_fixed_point_sums_give_the_f32_means(H, W, K, comp, kact):
    """Fixed-point sums turned back into means, from the plain version's
    labels, are within 1e-4 of the exact (f64) means of those labels, and
    no farther from them than the plain version's own f32 means plus 1e-5
    (at 65536 pixels a frame the f32 sums of the plain version are ~1.1e-4
    off, the fixed point's ~1.5e-5: the f32 rounding of a mean near 300);
    the next assignment from them gives >= 99.9% of the plain version's
    labels."""
    x = torch.from_numpy(quadrant(H, W, seed=K)[None].repeat(2, 0))
    x[1] = torch.from_numpy(np.random.RandomState(K).rand(H, W, 3)
                            .astype(np.float32))
    f5, c0, ratio, window = _grid_start(x, K, comp)
    labels, want = tsd.slic(x, K, comp, n_iter=1, n_active=kact,
                            init_centers=c0, return_centers=True)
    labels = labels.reshape(2, -1).long()
    got = _fixed_point_means(f5, labels, c0, kact, H, W)
    onehot = torch.nn.functional.one_hot(labels, K).double()
    n = onehot.sum(1)[..., None]
    exact = (onehot.transpose(1, 2) @ f5.double()) / n.clamp_min(1)
    exact = torch.where(n > 0, exact, c0.double())    # empty: kept
    err = float((got.double() - exact).abs().max())
    assert err <= 1e-4
    assert err <= float((want.double() - exact).abs().max()) + 1e-5
    nxt = tsd.slic(x, K, comp, n_iter=1, n_active=kact, init_centers=got)
    ref = tsd.slic(x, K, comp, n_iter=1, n_active=kact, init_centers=want)
    assert float((nxt == ref).float().mean()) >= 0.999


@pytest.mark.parametrize("H,W,n", [(64, 64, 9), (256, 256, 36), (40, 52, 12),
                                   (33, 47, 7), (8, 8, 100), (16, 64, 5)])
def test_round_kernel_grid_equals_initial_centers(H, W, n):
    """The round kernel's grid start, mirrored in Python doubles (cell
    centers in f64, then f32; times ratio in f32; gather at the truncated
    position; a short grid repeats), is ``initial_centers`` bit for bit."""
    gh, gw = tsd.grid_shape(H, W, n)
    ratio, _ = tsd.slic_geometry(H, W, n, 30.0)
    color = torch.from_numpy(np.random.RandomState(n).randn(2, H * W, 3)
                             .astype(np.float32))
    want = tsd.initial_centers(color, H, W, n, ratio)
    got = torch.empty_like(want)
    for k in range(n):
        m = k % (gh * gw)
        iy, ix = m // gw, m % gw
        cy = np.float32((iy + 0.5) * H / gh)
        cx = np.float32((ix + 0.5) * W / gw)
        p = min(max(int(cy), 0), H - 1) * W + min(max(int(cx), 0), W - 1)
        got[:, k, :3] = color[:, p]
        got[:, k, 3] = float(cy * np.float32(ratio))
        got[:, k, 4] = float(cx * np.float32(ratio))
    assert torch.equal(got, want)


def test_fixed_point_range_and_device_launches():
    from videowalk_tpu_torch.ops import slic as ts

    for H, W, n in ((256, 256, 36), (2160, 3840, 128), (480, 854, 36)):
        ts.check_fixed_point_range(H, W, tsd.slic_geometry(H, W, n, 50.0)[0])
    with pytest.raises(ValueError, match="fixed-point range"):
        ts.check_fixed_point_range(1 << 20, 1 << 20, 1.0)
    assert ts.device_launches(10) == 11
    assert ts.device_launches(10, return_centers=True) == 12
    assert ts.device_launches(1) == 2
