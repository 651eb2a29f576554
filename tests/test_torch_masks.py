"""``videowalk_tpu_torch/core/masks.py`` against the JAX package's
``core/masks.py``: the radius mask, the L1 decomposition and the dilation
structuring elements. All three are integer constructions: equality."""

import numpy as np
import pytest

from videowalk_tpu.core import masks as jm
from videowalk_tpu_torch.core import masks as tm


@pytest.mark.parametrize("H,W,radius", [(5, 7, 2.0), (8, 8, 3.5), (6, 4, 12.0)])
def test_radius_mask_equals_jax(H, W, radius):
    got = tm.radius_mask(H, W, radius)
    assert got.shape == (H, W, H, W) and str(got.dtype) == "torch.float32"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.radius_mask(H, W, radius)))


def test_l1_decomposition_equals_jax():
    for r in range(0, 40):
        assert tm.l1_decomposition(r) == jm.l1_decomposition(r)
        a, units = tm.l1_decomposition(r)
        if r >= 1:
            assert 2 * a + units == r       # the radii of the passes add up


@pytest.mark.parametrize("shape", ["L1", "cross", "circle"])
@pytest.mark.parametrize("k", [1, 3, 7, 55])
def test_dilation_kernel_equals_jax(k, shape):
    got = tm.make_dilation_kernel(k, shape)
    assert got.shape == (k, k)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.make_dilation_kernel(k, shape)))


def test_dilation_kernel_refuses_bad_arguments():
    with pytest.raises(ValueError, match="odd"):
        tm.make_dilation_kernel(4)
    with pytest.raises(ValueError, match="unknown dilation kernel shape"):
        tm.make_dilation_kernel(5, "square")
