"""Plain batched SLIC (a frozen copy of the port's plain version's
algorithm, written out on its own): CIELAB (D65) colors, positions scaled
by ``compactness / S`` with ``S = sqrt(HW / K)``, centers on a regular
grid, ``n_iter`` assignments with ``n_iter - 1`` center updates between
them. A pixel takes the nearest center within its 2S window (ties to the
lowest slot), or the unwindowed nearest where no center is in the window;
an empty cluster keeps its center. Distances are the direct ``sum (f -
c)^2`` in f32, one center a pass.

``feature_dtype=torch.bfloat16`` rounds the 5-D features and the centers
to bf16 first (the control one precision below f32)."""

from __future__ import annotations

import numpy as np
import torch


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    rgb = rgb.clamp(0.0, 1.0)
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    m = torch.tensor([[0.412453, 0.357580, 0.180423],
                      [0.212671, 0.715160, 0.072169],
                      [0.019334, 0.119193, 0.950227]], device=rgb.device)
    xyz = (lin[..., None, :] * m).sum(-1) / torch.tensor(
        [0.95047, 1.0, 1.08883], device=rgb.device)
    f = torch.where(xyz > 0.008856, xyz.clamp_min(0.008856) ** (1.0 / 3.0),
                    7.787 * xyz + 16.0 / 116.0)
    return torch.stack([116.0 * f[..., 1] - 16.0,
                        500.0 * (f[..., 0] - f[..., 1]),
                        200.0 * (f[..., 1] - f[..., 2])], dim=-1)


def grid_centers(H: int, W: int, K: int):
    gh = max(1, int(np.sqrt(K * H / W) + 0.5))
    gw = int(np.ceil(K / gh))
    yy, xx = np.meshgrid((np.arange(gh) + 0.5) * H / gh,
                         (np.arange(gw) + 0.5) * W / gw, indexing="ij")
    yy, xx = yy.ravel(), xx.ravel()
    reps = int(np.ceil(K / yy.size))
    return (np.tile(yy, reps)[:K].astype(np.float32),
            np.tile(xx, reps)[:K].astype(np.float32))


def slic(images: torch.Tensor, n_segments: int, compactness: float,
         n_iter: int = 10, feature_dtype=torch.float32) -> torch.Tensor:
    """``(..., H, W, 3)`` floats in [0, 1] -> ``(..., H, W)`` int64
    labels."""
    lead, (H, W) = images.shape[:-3], images.shape[-3:-1]
    x = images.reshape(-1, H, W, 3).float()
    B, K, dev = x.shape[0], n_segments, x.device
    S = (H * W / K) ** 0.5
    ratio = compactness / S
    window = 2.0 * S * ratio
    py, px = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    pos = torch.stack([py.reshape(-1), px.reshape(-1)], -1) * ratio
    feats = torch.cat([rgb_to_lab(x).reshape(B, H * W, 3),
                       pos.expand(B, -1, -1)], -1)
    cy, cx = grid_centers(H, W, K)
    idx = torch.from_numpy(np.clip(cy.astype(np.int64), 0, H - 1) * W
                           + np.clip(cx.astype(np.int64), 0, W - 1)).to(dev)
    centers = torch.cat([feats[:, idx, :3],
                         torch.from_numpy(np.stack([cy, cx], -1)).to(dev)
                         .expand(B, -1, -1) * ratio], -1)

    def cast(t):
        return t.to(feature_dtype).to(torch.float32)

    feats = cast(feats)
    labels = None
    for it in range(n_iter):
        c = cast(centers)
        best = torch.full((B, H * W), float("inf"), device=dev)
        best_win = torch.full((B, H * W), float("inf"), device=dev)
        lab = torch.zeros((B, H * W), dtype=torch.int64, device=dev)
        lab_win = torch.zeros_like(lab)
        for k in range(K):
            d = ((feats - c[:, k:k + 1]) ** 2).sum(-1)
            inside = (((pos[None, :, 0] - c[:, k:k + 1, 3]).abs() <= window)
                      & ((pos[None, :, 1] - c[:, k:k + 1, 4]).abs()
                         <= window))
            lab = torch.where(d < best, k, lab)
            best = torch.minimum(best, d)
            dw = torch.where(inside, d, float("inf"))
            lab_win = torch.where(dw < best_win, k, lab_win)
            best_win = torch.minimum(best_win, dw)
        labels = torch.where(torch.isinf(best_win), lab, lab_win)
        if it + 1 < n_iter:
            onehot = torch.nn.functional.one_hot(labels, K).to(torch.float64)
            sums = torch.einsum("bpk,bpc->bkc", onehot, feats.double())
            counts = onehot.sum(1)[..., None]
            centers = torch.where(counts > 0,
                                  (sums / counts.clamp_min(1.0)).float(),
                                  centers)
    return labels.reshape(*lead, H, W)
