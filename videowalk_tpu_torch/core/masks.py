"""Spatial masks: the label-propagation radius mask and the superpixel
dilation kernels (counterpart of ``videowalk_tpu/core/masks.py``; reference
``code/utils/__init__.py:354-411`` and ``:590-608``).

All three are small constants built with numpy on the host; callers move
them to their device.
"""

from __future__ import annotations

import numpy as np
import torch


def radius_mask(H: int, W: int, radius: float) -> torch.Tensor:
    """``(H, W, H, W)`` f32: ``mask[i, j, k, l] = 1`` iff the Euclidean
    distance between grid cells (i, j) and (k, l) is < ``radius``."""
    gx, gy = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dist = np.sqrt(
        (gx[None, None, :, :] - gx[:, :, None, None]) ** 2
        + (gy[None, None, :, :] - gy[:, :, None, None]) ** 2
    )
    return torch.from_numpy((dist < radius).astype(np.float32))


def l1_decomposition(r: int) -> tuple[int, int]:
    """An L1 (diamond) dilation of radius ``r`` as two diagonal segment
    dilations of half-length ``a`` plus ``units`` unit-diamond passes: odd
    r = diag((r-1)/2) + 1 diamond, even r = diag(r/2 - 1) + 2 diamonds. The
    plain dilation (``ops/dilation.py``) runs this decomposition."""
    return ((r - 1) // 2, 1) if r % 2 else (r // 2 - 1, 2)


def make_dilation_kernel(kernel_size: int,
                         kernel_shape: str = "L1") -> torch.Tensor:
    """Odd-size binary 2D structuring element ``(k, k)`` f32: 'L1' (diamond
    ``|di| + |dj| <= half``), 'cross' (center row and column) or 'circle'
    (``di^2 + dj^2 <= half^2``)."""
    if kernel_size % 2 == 0:
        raise ValueError("Use an odd kernel size")
    c = kernel_size // 2
    ii, jj = np.meshgrid(np.arange(kernel_size), np.arange(kernel_size),
                         indexing="ij")
    if kernel_shape == "L1":
        k = (np.abs(c - ii) + np.abs(c - jj)) <= c
    elif kernel_shape == "cross":
        k = (ii == c) | (jj == c)
    elif kernel_shape == "circle":
        k = ((c - ii) ** 2 + (c - jj) ** 2) <= c**2
    else:
        raise ValueError(f"unknown dilation kernel shape: {kernel_shape!r}")
    return torch.from_numpy(k.astype(np.float32))
