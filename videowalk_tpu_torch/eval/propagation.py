"""Autoregressive k-NN label propagation on the device.

Counterpart of ``videowalk_tpu/eval/propagation.py``'s sparse backend:

- ``context_index_bank``: long-term frame-0 anchors + a sliding short-term
  window of ``n_context`` frames (reference ``code/utils/test_utils.py``);
- ``propagate_labels``: a Python loop over target frames in place of
  ``lax.scan``. The label buffer is updated in place: each step's
  prediction is written at its frame index before the next step's launch
  reads it (stream order). Each step is one ``ops.prop_sparse`` call a
  tile-row band: one band on one device, or with ``devices`` (eval
  ``--data-parallel``) the bands spread over them (the JAX ``shard_map``
  over a mesh).

The JAX package's shape bucketing (``propagate_labels_bucketed``) exists
only to bound XLA recompiles; PyTorch runs eagerly, so it is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from videowalk_tpu_torch.ops.prop_sparse import prop_sparse, sparse_bands


def context_index_bank(n_context: int, long_mem: list[int], N: int) -> np.ndarray:
    """Source-frame indices for each of N target frames.

    Returns ``(N, L + n_context)`` int32: for target t (0-based among
    targets), the long-term anchors then the short-term window
    ``[t, t+1, ..., t+n_context-1]`` in the 0-padded global frame indexing
    (targets start at global index ``n_context``).
    """
    ll = []
    for t in long_mem:
        assert 0 <= t < N, "context frame out of bounds"
        idx = np.zeros((N, 1), np.int64)
        if t > 0:
            idx += t + (n_context + 1)
            idx[: n_context + t + 1] = 0
        ll.append(idx)
    ss = (np.arange(n_context)[None].repeat(N, 0)
          + np.arange(N)[:, None])
    return np.concatenate(ll + [ss], axis=-1).astype(np.int32)


def propagate_labels(feats: torch.Tensor, labels0: torch.Tensor,
                     key_indices, *, n_context: int, n_long: int, topk: int,
                     temperature: float, radius: float,
                     devices=None) -> torch.Tensor:
    """Autoregressive label propagation over a whole video.

    With ``devices`` (a list; one device may repeat), each target's query
    grid splits into ``sparse_shard_count`` tile-row bands, band ``d`` on
    ``devices[d % len(devices)]``: the features and the label buffer are
    copied to each device once a video, each band's prediction comes back
    to ``feats``' device in order, and the whole prediction goes into every
    device's buffer before the next target. Each query's candidates and
    sums do not depend on its band, so the result is bitwise the one of
    ``devices=None``.

    Args:
      feats: ``(N_total, C, H, W)`` per-frame features, L2-normalized over C;
        the first ``n_context`` entries are copies of frame 0.
      labels0: ``(N_total, H, W, L)`` soft label maps; entries at and after
        ``n_context`` are overwritten by predictions.
      key_indices: ``(N_targets, n_long + n_context)`` from
        ``context_index_bank``.
    Returns:
      ``(N_targets, H, W, L)`` predicted soft labels, on ``feats``' device.
    """
    N, C, H, W = feats.shape
    dev = feats.device
    rows = np.asarray(key_indices)
    feats_cl = feats.permute(0, 2, 3, 1).contiguous()       # (N, H, W, C)
    lbl_buf = labels0.to(dev, torch.float32).contiguous().clone()
    idx = torch.as_tensor(rows, dtype=torch.int32).to(dev)  # one upload
    gt0 = lbl_buf[0].clone()
    preds = torch.empty((rows.shape[0], H, W, lbl_buf.shape[-1]),
                        dtype=torch.float32, device=dev)
    kw = dict(n_long=n_long, topk=topk, temperature=temperature,
              radius=radius)
    devices = devices or [dev]
    bands = sparse_bands(H, len(devices))
    on = [torch.device(devices[d % len(devices)]) for d in range(len(bands))]
    # one copy of the keys, the buffer and the indices a device (``to``
    # returns the tensor itself on its own device)
    copies = {d: (feats_cl.to(d), lbl_buf.to(d), idx.to(d))
              for d in dict.fromkeys([dev, *on])}
    for i in range(rows.shape[0]):
        t_global = int(rows[i, -1]) + 1  # target = last short-term ctx + 1
        parts = [prop_sparse(copies[d][0], copies[d][1], copies[d][2][i],
                             t_global, rows=band, **kw)
                 for band, d in zip(bands, on)]
        pred = (parts[0].to(dev) if len(parts) == 1 else
                torch.cat([p.to(dev) for p in parts])).view(H, W, -1)
        # Reference quirk (code/test.py:156-160): the FIRST target's
        # prediction is the ground-truth frame-0 labels, in the buffer and
        # in the output.
        if t_global == n_context:
            pred = gt0
        for _, buf, _ in copies.values():
            buf[t_global] = pred.to(buf.device)
        preds[i] = pred
    return preds
