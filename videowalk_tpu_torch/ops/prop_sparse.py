"""Block-sparse top-k label propagation for one target frame.

Replaces the Pallas TPU kernel ``videowalk_tpu/ops/prop_sparse_kernel.py``
(``_kernel``, reached through ``sparse_band_propagate`` and
``sparse_topk_propagate``). Per valid query cell of the target frame:

- candidates: every in-frame cell of each of the ``n_long`` long-term frames
  (raster order), then, for each short-term frame in context-slot order, the
  in-frame cells within the exact disk ``dy^2 + dx^2 < radius^2`` (window
  row-major, which is raster order);
- logit ``dot_f32(q, k) / T``; top-k, a tie going to the earlier candidate;
- prediction ``sum_j exp(a_j - a_max) label_j / sum_j exp(a_j - a_max)``.

``prop_sparse`` is the wrapper: a CPU tensor takes ``prop_sparse_plain``
(plain PyTorch, the same function with the same tie rule); a CUDA tensor
launches the hand-written Hopper kernel ``csrc/prop_sparse.cu`` or raises.
``prop_sparse.launches`` counts kernel launches. ``rows=(row0, n_rows)``
takes one band of tile rows of the query grid (each ``TQ`` cells high;
the keys keep the whole frame): the kernel's grid covers those rows alone,
and a frame's bands give its unbanded bits (``sparse_bands``,
``sparse_shard_count``: eval ``--data-parallel``).

Bound on the card: operations. At DAVIS-480p (C=256, 60x107, 1 long + 20
short frames, r=12) a target needs ~6420 x 15.5k valid (query, candidate)
pairs x 256 FMAs ~ 51 GFLOP of f32 products (0.76 ms at the f32 peak),
while its unique key bytes (~140 MB) are mostly reused from L2. Per 8x8
query tile it scores the long frames' every cell and, in each short frame,
the union of the tile's disks (``disk_union_offsets``), and keeps a running
top-k per query (see the source's note); the tile's queries stay in shared
memory where they fit and stream beside the keys where they do not
(``streams_query``: ResNet-50's 1024 and 2048 channels). The TPU layout
constraints (128-lane label padding, 128-aligned C, 4-aligned halo, padded
raster) do not apply. Its gate is its shared-memory budget.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

TQ = 8                 # query tile side of the kernel
MAX_TOPK = 32          # largest k the kernel takes
SMEM_LIMIT = 232448    # opt-in shared memory of one Hopper block, bytes


def sparse_halo(radius: float) -> int:
    """Half-width of the short-term candidate window around a query tile:
    ``ceil(radius) - 1`` is the largest ``|d|`` of the disk
    ``d^2 < radius^2``; the exact disk is applied per (query, key) pair."""
    return max(int(np.ceil(radius)) - 1, 0)


def disk_union_offsets(radius: float, tile: int = TQ) -> np.ndarray:
    """``(n, 2)`` int offsets ``(oy, ox)`` from a ``tile x tile`` query
    tile's corner of the cells some query of the tile takes (``dy^2 + dx^2
    < radius^2`` in f32 for one of them), row-major: the union of the
    tile's disks that the kernel scores in each short frame, in candidate
    order. (The source computes it per block, by each cell's distance to the
    tile's nearest query, and cuts it to the frame.)"""
    rr = sparse_halo(radius)
    d = np.arange(-rr, tile + rr)
    oy, ox = np.meshgrid(d, d, indexing="ij")
    dyc = oy - np.clip(oy, 0, tile - 1)
    dxc = ox - np.clip(ox, 0, tile - 1)
    keep = (dyc * dyc + dxc * dxc).astype(np.float32) < np.float32(radius * radius)
    return np.stack([oy[keep], ox[keep]], axis=1)


def _smem_form_bytes(C: int, topk: int, radius: float,
                     stream_q: bool) -> int:
    nq, kc, cs = TQ * TQ, 256, 32
    rows = TQ + 2 * sparse_halo(radius)
    q = 2 * nq * cs if stream_q else nq * (-(-C // cs) * cs)
    return (4 * (q + 2 * kc * cs) + nq * topk * 8 + 2 * kc * 12 + 8 * 64 * 4
            + rows * 16 + 16)


def streams_query(C: int, topk: int, radius: float) -> bool:
    """Whether the kernel streams the query tile (32 channels a step,
    beside the keys) because the resident tile does not fit one block's
    shared memory: C > 576 at k = 10 and r = 12 (ResNet-50's 1024 and
    2048). Both forms give the same bits."""
    return _smem_form_bytes(C, topk, radius, False) > SMEM_LIMIT


def smem_bytes(C: int, topk: int, radius: float) -> int:
    """Dynamic shared memory of one launch (mirrors the source's
    ``prop_sparse_smem_bytes``): the query tile, resident (rows of C
    rounded up to 32 floats) or, where that does not fit, streamed (two
    stages of 64 queries x 32 channels); two key stages of 256 keys x 32
    channels, the top-k lists (values and ids), two chunks' key cells, tile
    offsets and slots, eight warps' 64-float scratch, the disk union's row
    table (``TQ + 2 * halo`` rows of 16 bytes), two counters."""
    return _smem_form_bytes(C, topk, radius, streams_query(C, topk, radius))


def sparse_supported(C: int, topk: int, n_lbl: int, radius: float) -> bool:
    """Shape gate of the CUDA kernel: 16-byte rows (C % 4 == 0), k within the
    kernel's bound, and the launch within one block's shared memory (any C
    with the query tile streamed; the halo's row table bounds the
    radius)."""
    return (C % 4 == 0 and 1 <= topk <= MAX_TOPK and n_lbl >= 1
            and smem_bytes(C, topk, radius) <= SMEM_LIMIT)


def sparse_shard_count(H: int, tile: int, n_devices: int) -> int:
    """The active band count of propagation at height ``H`` over
    ``n_devices`` (the JAX package's formula): each band takes
    ``ceil(tile_rows / n_devices)`` tile rows, so ``ceil(rows / that)``
    bands hold rows. DAVIS-480p (H = 60): 8 tile rows, 8 bands on 8
    devices; JHMDB's 40: 5 rows, 5 bands of 8."""
    nth = -(-H // tile)
    per_band = -(-nth // max(1, int(n_devices)))
    return -(-nth // per_band)


def sparse_bands(H: int, n_devices: int) -> list[tuple[int, int]]:
    """``(row0, n_rows)`` tile-row bands of a height-``H`` query grid over
    ``n_devices``: ``sparse_shard_count`` bands of ``ceil(tile_rows /
    n_devices)`` rows, the last one cut to the grid."""
    nth = -(-H // TQ)
    per = -(-nth // max(1, int(n_devices)))
    return [(r, min(per, nth - r)) for r in range(0, nth, per)]


def valid_pairs(H: int, W: int, radius: float, n_long: int,
                n_short: int) -> int:
    """(query, candidate) pairs one target needs: ``n_long * HW * HW`` plus,
    per short frame, the in-frame cells of every query's disk."""
    rr = sparse_halo(radius)
    d = np.arange(-rr, rr + 1)
    dy, dx = np.meshgrid(d, d, indexing="ij")
    disk = (dy * dy + dx * dx).astype(np.float32) < np.float32(radius * radius)
    per = (np.maximum(H - np.abs(dy), 0) * np.maximum(W - np.abs(dx), 0))
    return int(n_long * (H * W) ** 2 + n_short * per[disk].sum())


def _band_cells(H: int, W: int, rows) -> tuple[int, int]:
    """The first and last-plus-one frame rows of tile-row band ``rows``
    (the whole frame for None)."""
    if rows is None:
        return 0, H
    row0, n_rows = rows
    if row0 < 0 or n_rows < 1 or row0 + n_rows > -(-H // TQ):
        raise ValueError(f"prop_sparse: tile rows {rows} outside the "
                         f"{-(-H // TQ)} of a height-{H} grid")
    return row0 * TQ, min(H, (row0 + n_rows) * TQ)


def prop_sparse_plain(feats: torch.Tensor, labels: torch.Tensor,
                      ctx: torch.Tensor, t_query: int, *, n_long: int,
                      topk: int, temperature: float, radius: float,
                      rows: tuple[int, int] | None = None) -> torch.Tensor:
    """The plain PyTorch version, frame by frame: a stable descending sort
    of each frame's candidates (raster order) merged into the running top-k
    with another stable sort, so ties keep the earlier candidate. ``rows``:
    the queries of that tile-row band alone."""
    N, H, W, C = feats.shape
    HW, nl = H * W, labels.shape[-1]
    dev = feats.device
    y0, y1 = _band_cells(H, W, rows)
    q = feats[t_query, y0:y1].reshape(-1, C)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    qy, qx = yy[y0 * W:y1 * W], xx[y0 * W:y1 * W]
    d2 = ((qy[:, None] - yy[None]) ** 2 + (qx[:, None] - xx[None]) ** 2)
    outside = ~(d2.to(torch.float32) < float(np.float32(radius * radius)))
    inv_t = float(np.float32(1.0 / temperature))
    best_v = torch.empty((q.shape[0], 0), dtype=torch.float32, device=dev)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=dev)
    for l, f in enumerate(ctx.tolist()):
        a = (q @ feats[f].reshape(HW, C).T) * inv_t
        if l >= n_long:
            a = a.masked_fill(outside, float("-inf"))
        v, i = torch.sort(a, dim=1, descending=True, stable=True)
        cat_v = torch.cat([best_v, v[:, :topk]], dim=1)
        cat_i = torch.cat([best_i, i[:, :topk] + l * HW], dim=1)
        best_v, sel = torch.sort(cat_v, dim=1, descending=True, stable=True)
        best_v = best_v[:, :topk]
        best_i = torch.gather(cat_i, 1, sel[:, :topk])
    e = torch.exp(best_v - best_v[:, :1])                   # -inf slots -> 0
    frames = ctx.to(dev, torch.int64)[best_i // HW]
    lab = labels.reshape(N * HW, nl)[frames * HW + best_i % HW]
    return (e[..., None] * lab).sum(1) / e.sum(1, keepdim=True)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _lib():
    from videowalk_tpu_torch.ops import _build

    lib = _build.load("prop_sparse")
    if lib.prop_sparse_launch.argtypes is None:
        lib.prop_sparse_launch.argtypes = _ARGTYPES
        lib.prop_sparse_launch.restype = ctypes.c_int
        lib.prop_sparse_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.prop_sparse_smem_bytes.restype = ctypes.c_size_t
    return lib


def prop_sparse(feats: torch.Tensor, labels: torch.Tensor, ctx: torch.Tensor,
                t_query: int, *, n_long: int, topk: int, temperature: float,
                radius: float,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
    """One target frame's predicted soft labels (of one tile-row band with
    ``rows=(row0, n_rows)``).

    Args:
      feats: ``(N, H, W, C)`` float32 L2-normalized per-frame features.
      labels: ``(N, H, W, nl)`` float32 label buffer (predictions of earlier
        targets already written at their frame index).
      ctx: ``(L,)`` int32 context frame indices, long-term first.
      t_query: index of the target frame in ``feats``.
    Returns:
      ``(H * W, nl)`` float32 predictions, raster order; with ``rows``,
      the ``(y1 - y0) * W`` cells of frame rows ``y0 = 8 row0`` to ``y1 =
      min(H, 8 (row0 + n_rows))``.
    """
    kw = dict(n_long=n_long, topk=topk, temperature=temperature,
              radius=radius, rows=rows)
    if feats.device.type == "cpu":
        return prop_sparse_plain(feats, labels, ctx, t_query, **kw)
    if feats.device.type != "cuda":
        raise ValueError(f"prop_sparse: unsupported device {feats.device}")
    N, H, W, C = feats.shape
    nl = labels.shape[-1]
    L = int(ctx.shape[0])
    if labels.shape[:3] != (N, H, W) or ctx.dim() != 1:
        raise ValueError(f"prop_sparse: shapes feats {tuple(feats.shape)}, "
                         f"labels {tuple(labels.shape)}, ctx {tuple(ctx.shape)}")
    for name, t, dt in (("feats", feats, torch.float32),
                        ("labels", labels, torch.float32),
                        ("ctx", ctx, torch.int32)):
        if t.device != feats.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"prop_sparse: {name} must be a contiguous {dt} "
                             f"tensor on {feats.device}")
    if feats.data_ptr() % 16:
        raise ValueError("prop_sparse: feats must be 16-byte aligned (the "
                         "kernel copies rows 16 bytes at a time)")
    if not sparse_supported(C, topk, nl, radius) or not 0 <= n_long <= L \
            or not 0 <= t_query < N:
        raise ValueError(
            f"prop_sparse: the CUDA kernel does not take C={C}, topk={topk}, "
            f"n_lbl={nl}, radius={radius}, n_long={n_long}, L={L}, "
            f"t_query={t_query} (needs C % 4 == 0, 1 <= topk <= {MAX_TOPK}, "
            f"{smem_bytes(C, topk, radius)} <= {SMEM_LIMIT} bytes of shared "
            f"memory)")
    y0, y1 = _band_cells(H, W, rows)
    row0 = y0 // TQ
    out = torch.empty(((y1 - y0) * W, nl), dtype=torch.float32,
                      device=feats.device)
    rr = sparse_halo(radius)
    with torch.cuda.device(feats.device):
        err = _lib().prop_sparse_launch(
            feats.data_ptr(), labels.data_ptr(), ctx.data_ptr(),
            out.data_ptr(), H, W, C, nl, L, n_long, int(t_query), topk,
            float(np.float32(1.0 / temperature)),
            float(np.float32(radius * radius)), rr, row0,
            -(-y1 // TQ) - row0,
            torch.cuda.current_stream(feats.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"prop_sparse kernel launch failed: cudaError {err}")
    prop_sparse.launches += 1
    return out


prop_sparse.launches = 0
