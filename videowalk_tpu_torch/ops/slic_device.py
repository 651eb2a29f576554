"""Batched SLIC superpixels in plain PyTorch (counterpart of
``videowalk_tpu/ops/slic_device.py``).

The reference computes SLIC per frame with scikit-image inside CPU loader
workers (``code/data/superpixels.py:9-15``); this runs it on the training
device, batched over every leading dimension:

- assignment: squared 5-D distance expanded as ``|f|^2 - 2 f.c + |c|^2``
  (one batched product a round); the SLIC 2S window is a coordinate mask;
  pixels with no in-window center take the unwindowed nearest; ties go to the
  lowest slot;
- center update: segment means by a one-hot product; an empty cluster keeps
  its center;
- a fixed count of rounds.

It materializes a ``(B, HW, K)`` distance tensor every round, which is what
the fused kernel (``ops/slic.py``) keeps out of device memory: this module
is that kernel's plain version, and what a CPU tensor gets.

Differences from skimage's SLIC: no enforce-connectivity pass, grid
initialization without perturbation; CIELAB like ``convert2lab=True``;
spatial distances are scaled by ``compactness / S`` against unscaled Lab.
"""

from __future__ import annotations

import numpy as np
import torch

from videowalk_tpu_torch.utils.device import full_f32_matmul


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] ``(..., 3)`` -> CIELAB (D65) like
    ``skimage.color.rgb2lab``: L in [0, 100], a/b roughly [-128, 127]."""
    rgb = rgb.clamp(0.0, 1.0)
    linear = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                         rgb / 12.92)
    m = torch.tensor([[0.412453, 0.357580, 0.180423],
                      [0.212671, 0.715160, 0.072169],
                      [0.019334, 0.119193, 0.950227]],
                     dtype=rgb.dtype, device=rgb.device)
    # three columns, each a 3-term sum: not a matrix product (TF32-proof)
    xyz = (linear[..., None, :] * m).sum(-1)
    white = torch.tensor([0.95047, 1.0, 1.08883], dtype=rgb.dtype,
                         device=rgb.device)
    xyz = xyz / white
    eps, kappa = 0.008856, 7.787
    # torch has no cbrt: pow(1/3) on the positive branch
    f = torch.where(xyz > eps, xyz.clamp_min(eps) ** (1.0 / 3.0),
                    kappa * xyz + 16.0 / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)


def grid_shape(H: int, W: int, n_segments: int) -> tuple[int, int]:
    """``(rows, columns)`` of the initial centers' grid."""
    gh = int(np.sqrt(n_segments * H / W) + 0.5)
    gw = int(np.ceil(n_segments / max(1, gh)))
    return max(1, gh), gw


def _grid_centers(H: int, W: int, n_segments: int):
    """Regular-grid initial centers (y, x) as f32 numpy arrays, like
    skimage's mgrid slices; a grid that comes up short repeats from its
    start."""
    gh, gw = grid_shape(H, W, n_segments)
    ys = (np.arange(gh) + 0.5) * H / gh
    xs = (np.arange(gw) + 0.5) * W / gw
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    yy, xx = yy.ravel()[:n_segments], xx.ravel()[:n_segments]
    if yy.size < n_segments:
        reps = int(np.ceil(n_segments / yy.size))
        yy = np.tile(yy, reps)[:n_segments]
        xx = np.tile(xx, reps)[:n_segments]
    return yy.astype(np.float32), xx.astype(np.float32)


def slic_geometry(H: int, W: int, n_segments: int, compactness: float):
    """``(ratio, window)``: the spatial scale ``compactness / S`` with
    ``S = sqrt(HW / n_segments)``, and the 2S window in scaled coordinates."""
    S = (H * W / n_segments) ** 0.5
    ratio = compactness / S
    return ratio, 2.0 * S * ratio


def initial_centers(color: torch.Tensor, H: int, W: int, n_segments: int,
                    ratio: float) -> torch.Tensor:
    """``(B, K, 5)`` grid centers ``[color at the grid point, y * ratio,
    x * ratio]`` for ``color (B, HW, 3)``."""
    cy0, cx0 = _grid_centers(H, W, n_segments)
    ci = (np.clip(cy0.astype(np.int32), 0, H - 1) * W
          + np.clip(cx0.astype(np.int32), 0, W - 1))
    dev = color.device
    c_color = color[:, torch.from_numpy(ci.astype(np.int64)).to(dev), :]
    pos = torch.from_numpy(np.stack([cy0, cx0], -1)).to(dev) * ratio
    return torch.cat([c_color, pos.expand(color.shape[0], -1, -1)], dim=-1)


def check_slic_args(images: torch.Tensor, n_segments: int, n_iter: int,
                    n_active, init_centers):
    """Shared argument checks of ``slic`` and ``slic_fused``; returns the
    flat batch size and ``n_active`` as ``(B,)`` int32 on the images' device
    (or None)."""
    if images.dim() < 3 or images.shape[-1] != 3:
        raise ValueError(f"slic: images must be (..., H, W, 3); got "
                         f"{tuple(images.shape)}")
    if not images.is_floating_point():
        raise ValueError(f"slic: images must be floats in [0, 1]; got "
                         f"{images.dtype}")
    if n_segments < 1 or n_iter < 1:
        raise ValueError(f"slic: n_segments={n_segments}, n_iter={n_iter}")
    H, W = images.shape[-3], images.shape[-2]
    B = images.numel() // (H * W * 3)
    if n_active is not None:
        n_active = torch.as_tensor(n_active, device=images.device).reshape(-1)
        if n_active.numel() != B:
            raise ValueError(f"slic: n_active has {n_active.numel()} entries "
                             f"for {B} images")
        n_active = n_active.to(torch.int32)
    if init_centers is not None and (
            tuple(init_centers.shape) != (B, n_segments, 5)
            or init_centers.device != images.device):
        raise ValueError(
            f"slic: init_centers must be ({B}, {n_segments}, 5) on "
            f"{images.device}; got {tuple(init_centers.shape)} on "
            f"{init_centers.device}")
    return B, n_active


def slic(images: torch.Tensor, n_segments: int = 36, compactness: float = 50.0,
         n_iter: int = 10, convert_lab: bool = True, n_active=None,
         init_centers: torch.Tensor | None = None,
         return_centers: bool = False):
    """Batched SLIC segmentation.

    Args:
      images: ``(..., H, W, 3)`` floats in [0, 1] (any leading dims).
      n_segments: number of superpixel centers (reference --num-sp).
      compactness: SLIC compactness (reference --compactness).
      n_iter: rounds of (assignment, center update); the labels returned are
        the last round's assignment.
      n_active: optional per-image active center counts (the leading dims,
        values in [1, n_segments]): centers with index >= n_active never win
        (the reference's per-frame randomized segment counts).
      init_centers: ``(B, n_segments, 5)`` centers in feature space
        ``[L, a, b, y * ratio, x * ratio]`` to start from in place of the
        grid; with ``n_iter=1`` the result is one assignment from them.
      return_centers: also return the ``(B, n_segments, 5)`` centers after
        the last round's update.

    Returns:
      ``(..., H, W)`` int32 labels in [0, n_segments).
    """
    B, n_active = check_slic_args(images, n_segments, n_iter, n_active,
                                  init_centers)
    lead = images.shape[:-3]
    H, W = images.shape[-3], images.shape[-2]
    dev = images.device
    x = images.reshape(B, H, W, 3).float()
    disabled = None
    if n_active is not None:
        disabled = (torch.arange(n_segments, device=dev)[None, :]
                    >= n_active[:, None])                   # (B, K)

    color = (rgb_to_lab(x) if convert_lab else x * 100.0).reshape(B, H * W, 3)
    ratio, window = slic_geometry(H, W, n_segments, compactness)
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    coords = torch.stack([py.reshape(-1) * ratio, px.reshape(-1) * ratio], -1)
    f5 = torch.cat([color, coords.expand(B, -1, -1)], dim=-1)   # (B, HW, 5)
    centers = (initial_centers(color, H, W, n_segments, ratio)
               if init_centers is None else init_centers.float())
    f_sq = (f5 * f5).sum(-1, keepdim=True)                  # (B, HW, 1)
    inf = torch.tensor(float("inf"), device=dev)

    def assign(c):
        # (B, HW, K) squared distances: the three terms are ~1e5 and cancel
        # to a few units, so the product must be full f32 (the caller wraps
        # the rounds in ``full_f32_matmul``)
        d = f_sq - 2.0 * torch.bmm(f5, c.transpose(1, 2)) \
            + (c * c).sum(-1)[:, None, :]
        if disabled is not None:
            d = torch.where(disabled[:, None, :], inf, d)
        dy = (coords[None, :, 0:1] - c[:, None, :, 3]).abs()
        dx = (coords[None, :, 1:2] - c[:, None, :, 4]).abs()
        dw = torch.where((dy > window) | (dx > window), inf, d)
        # pixels with no in-window center take the unwindowed nearest
        no_valid = torch.isinf(dw).all(-1, keepdim=True)
        return torch.where(no_valid, d, dw).argmin(-1)      # first minimum

    labels = None
    with full_f32_matmul():
        for i in range(n_iter):
            labels = assign(centers)
            if i + 1 < n_iter or return_centers:
                onehot = torch.nn.functional.one_hot(labels,
                                                     n_segments).float()
                sums = torch.bmm(onehot.transpose(1, 2), f5)    # (B, K, 5)
                counts = onehot.sum(1)[..., None]
                centers = torch.where(
                    counts > 0, sums / counts.clamp_min(1.0), centers)
    labels = labels.reshape(*lead, H, W).to(torch.int32)
    return (labels, centers) if return_centers else labels
