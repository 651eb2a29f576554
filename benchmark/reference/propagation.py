"""Plain k-NN label propagation over a video (the reference eval's
``code/test.py`` loop, dense and in f32).

The first ``n_context`` frames are copies of frame 0. Target ``t`` (0-based,
global frame ``t + n_context``) reads the long-term frames (frame 0 for
``long_mem = [0]``) whole and the ``n_context`` frames before it within
the disk ``dy^2 + dx^2 < radius^2`` of each query cell; it keeps the top
``topk`` logits ``dot(q, k) / T``, weights them by a softmax and sums
their labels. The prediction goes into the label buffer at its frame
before the next target reads it; the first target's prediction is frame
0's labels (the reference's quirk, ``code/test.py:156-160``)."""

from __future__ import annotations

import numpy as np
import torch


def context_rows(n_context: int, long_mem: list[int], n_targets: int):
    """``(n_targets, len(long_mem) + n_context)`` source frames a target."""
    rows = []
    for t in range(n_targets):
        row = []
        for m in long_mem:
            row.append(0 if m == 0 or t <= n_context + m else
                       m + n_context + 1)
        row += list(range(t, t + n_context))
        rows.append(row)
    return np.asarray(rows, np.int64)


def propagate(feats: torch.Tensor, labels0: torch.Tensor, *, n_context: int,
              long_mem: list[int], topk: int, temperature: float,
              radius: float, block: int = 2048) -> torch.Tensor:
    """``feats (N, C, H, W)`` L2-normalized, ``labels0 (N, H, W, L)`` ->
    ``(N - n_context, H, W, L)`` predictions, queries in blocks of
    ``block`` cells."""
    N, C, H, W = feats.shape
    HW, nl = H * W, labels0.shape[-1]
    dev = feats.device
    keys = feats.permute(0, 2, 3, 1).reshape(N, HW, C)
    buf = labels0.reshape(N, HW, nl).to(dev, torch.float32).clone()
    gt0 = buf[0].clone()
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    rows = context_rows(n_context, long_mem, N - n_context)
    n_long = len(long_mem)
    inv_t = 1.0 / temperature
    out = torch.empty((N - n_context, HW, nl), device=dev)
    for t, ctx in enumerate(rows):
        tq = int(ctx[-1]) + 1
        cand = keys[torch.as_tensor(ctx, device=dev)]        # (L, HW, C)
        cand_lbl = buf[torch.as_tensor(ctx, device=dev)].reshape(-1, nl)
        pred = torch.empty((HW, nl), device=dev)
        for q0 in range(0, HW, block):
            q = keys[tq, q0:q0 + block]
            logits = torch.einsum("qc,lkc->qlk", q, cand) * inv_t
            d2 = ((yy[q0:q0 + block, None] - yy[None]) ** 2
                  + (xx[q0:q0 + block, None] - xx[None]) ** 2)
            far = d2.to(torch.float32) >= radius * radius
            logits[:, n_long:] = logits[:, n_long:].masked_fill(
                far[:, None], float("-inf"))
            v, i = torch.topk(logits.reshape(q.shape[0], -1), topk, dim=1)
            w = torch.softmax(v, dim=1)
            pred[q0:q0 + block] = (w[..., None] * cand_lbl[i]).sum(1)
        if tq == n_context:
            pred = gt0
        buf[tq] = pred
        out[t] = pred
    return out.reshape(N - n_context, H, W, nl)
