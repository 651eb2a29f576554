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
