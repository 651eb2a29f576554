"""Propagation in tile-row bands (eval ``--data-parallel``): the port's
``propagate_labels(devices=...)`` and ``prop_sparse(rows=...)`` on the CPU
(the kernel's plain version), held bitwise to the unbanded port and, at
``tests/test_prop_sharded.py``'s shapes, to the JAX package's sharded
sparse path (``mesh=make_mesh(D)``, Pallas in interpret mode) within rtol
1e-4, atol 1e-5 (``tests/test_torch_prop_sparse.py``'s tolerance: two f32
evaluations of each logit). The shapes take uneven bands (a band
straddling the grid's edge) and more devices than tile rows."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videowalk_tpu.eval.propagation import propagate_labels as jax_propagate
from videowalk_tpu.ops.prop_sparse_kernel import (
    sparse_shard_count as jax_shard_count)
from videowalk_tpu.parallel import make_mesh

from videowalk_tpu_torch.eval.propagation import (context_index_bank,
                                                  propagate_labels)
from videowalk_tpu_torch.ops.prop_sparse import (TQ, prop_sparse,
                                                 sparse_bands,
                                                 sparse_shard_count)

torch.set_num_threads(1)


def _setup(seed, n_context, n_targets, C, H, W, n_lbl):
    rng = np.random.RandomState(seed)
    N = n_targets + n_context
    feats = rng.randn(N, C, H, W).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    labels0 = np.zeros((N, H, W, n_lbl), np.float32)
    labels0[:n_context + 1] = np.eye(n_lbl, dtype=np.float32)[
        rng.randint(0, n_lbl, (H, W))]
    return feats, labels0


@pytest.mark.parametrize("H,W,n_dev,radius,long_mem,seed", [
    (32, 12, 4, 3.0, [0], 0),     # 4 tile rows over 4 devices
    (61, 10, 8, 3.0, [0], 0),     # 8 rows, the last one partial
    (32, 10, 4, 5.0, [0], 5),     # odd radius
    (24, 9, 3, 3.0, [0, 1], 1),   # two long-term frames
    (37, 10, 2, 3.0, [0], 7),     # 5 rows over 2: a band past the grid
    (20, 12, 8, 3.0, [0], 7),     # 3 rows over 8 devices
])
def test_bands_match_unbanded_and_the_jax_mesh(H, W, n_dev, radius,
                                               long_mem, seed):
    n_context, n_targets, C, n_lbl = 3, 4, 8, 4
    feats, labels0 = _setup(seed, n_context, n_targets, C, H, W, n_lbl)
    idx = context_index_bank(n_context, long_mem, n_targets)
    kw = dict(n_context=n_context, n_long=len(long_mem), topk=4,
              temperature=0.07, radius=radius)
    f, l0 = torch.from_numpy(feats), torch.from_numpy(labels0)
    want = propagate_labels(f, l0, idx, **kw)
    got = propagate_labels(f, l0, idx, devices=["cpu"] * n_dev, **kw)
    assert torch.equal(got, want)
    jax_got = np.asarray(jax_propagate(
        jnp.asarray(feats), jnp.asarray(labels0), jnp.asarray(idx),
        mesh=make_mesh(n_dev), backend="sparse_interpret", **kw))
    np.testing.assert_allclose(got.numpy(), jax_got, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("H,n_dev", [(60, 8), (60, 6), (56, 8), (40, 8),
                                     (40, 2), (8, 8), (61, 3), (37, 2),
                                     (20, 8), (1, 4)])
def test_sparse_shard_count_matches_jax(H, n_dev):
    """The active band count, and ``sparse_bands``' bands: that many, each
    ``ceil(rows / n_dev)`` tile rows but the last, covering the grid."""
    n = sparse_shard_count(H, 8, n_dev)
    assert n == jax_shard_count(H, 8, n_dev)
    bands = sparse_bands(H, n_dev)
    assert len(bands) == n
    per = -(-(-(-H // TQ)) // n_dev)
    assert [b[0] for b in bands] == [i * per for i in range(n)]
    assert sum(b[1] for b in bands) == -(-H // TQ)


def test_band_rows_are_the_whole_frame_rows():
    """``prop_sparse(rows=...)``: each band's cells are the whole frame's
    rows of that band, bitwise; a band outside the grid raises."""
    H, W, n_context = 21, 11, 3
    feats, labels0 = _setup(3, n_context, 2, 8, H, W, 3)
    fcl = torch.from_numpy(feats).permute(0, 2, 3, 1).contiguous()
    lbl = torch.from_numpy(labels0)
    ctx = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    kw = dict(n_long=1, topk=3, temperature=0.07, radius=4.0)
    whole = prop_sparse(fcl, lbl, ctx, n_context + 1, **kw)
    for row0, n_rows in ((0, 1), (1, 2), (2, 1), (0, 3)):
        part = prop_sparse(fcl, lbl, ctx, n_context + 1,
                           rows=(row0, n_rows), **kw)
        y0, y1 = row0 * TQ, min(H, (row0 + n_rows) * TQ)
        assert torch.equal(part, whole[y0 * W:y1 * W])
    for bad in ((3, 1), (0, 4), (-1, 1), (0, 0)):
        with pytest.raises(ValueError, match="tile rows"):
            prop_sparse(fcl, lbl, ctx, n_context + 1, rows=bad, **kw)
