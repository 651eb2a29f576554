"""Feature visualization (counterpart of ``videowalk_tpu/utils/visualize.py``;
reference ``code/utils/visualize.py``): the PCA of feature maps to RGB that
the eval CLI's ``--pca-vis`` writes. numpy SVD in place of sklearn."""

from __future__ import annotations

import numpy as np


def _normalize01(x: np.ndarray) -> np.ndarray:
    """Min-max to [0, 1] with a 1e-12 floor."""
    x = np.asarray(x)
    lo = x.min()
    return (x - lo) / max(x.max() - lo, 1e-12)


def pca_feats(ff: np.ndarray, K: int = 1, whiten: bool = True,
              img_normalize: bool = True):
    """PCA feature maps -> RGB images (reference :22-44).

    Args:
      ff: (N, C, H, W) features.
    Returns:
      (N, 3, H, W) in [0, 1] (or a list of K such arrays).
    """
    ff = np.asarray(ff, np.float64)
    N, C, H, W = ff.shape
    X = ff.transpose(0, 2, 3, 1).reshape(-1, C)
    X = X - X.mean(0, keepdims=True)
    U, S, Vt = np.linalg.svd(X, full_matrices=False)
    comps = U[:, :3 * K] * (np.sqrt(X.shape[0] - 1) if whiten
                            else S[:3 * K][None])
    pca_ff = comps.reshape(N, H, W, 3 * K).transpose(0, 3, 1, 2)
    outs = [pca_ff[:, kk:kk + 3] for kk in range(0, 3 * K, 3)]
    if img_normalize:
        outs = [_normalize01(x) for x in outs]
    return outs[0] if K == 1 else outs
