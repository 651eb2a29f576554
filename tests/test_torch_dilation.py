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
from videowalk_tpu_torch.ops.dilation import dilate_l1, dilate_l1_plain

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
