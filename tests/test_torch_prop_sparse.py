"""The port's propagation (plain PyTorch version of the sparse kernel, on
the CPU) against the JAX package's Pallas kernel in interpret mode
(``propagate_labels(backend="sparse_interpret")``), at the shapes of
``tests/test_prop_sparse_kernel.py``. Tolerance rtol 1e-4, atol 1e-5, as in
the JAX kernel's own tests (f32 affinities summed in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videowalk_tpu.eval.propagation import propagate_labels as jax_propagate

from videowalk_tpu_torch.eval.propagation import (context_index_bank,
                                                  propagate_labels)
from videowalk_tpu_torch.ops import prop_sparse as ps

torch.set_num_threads(1)


def _setup(seed, n_context, N_targets, C, H, W, n_lbl):
    rng = np.random.RandomState(seed)
    N = N_targets + n_context
    feats = rng.randn(N, C, H, W).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    labels0 = np.zeros((N, H, W, n_lbl), np.float32)
    onehot = rng.randint(0, n_lbl, (H, W))
    labels0[: n_context + 1] = np.eye(n_lbl, dtype=np.float32)[onehot]
    return feats, labels0


def _both(feats, labels0, key_indices, **kw):
    want = np.asarray(jax_propagate(
        jnp.asarray(feats), jnp.asarray(labels0), jnp.asarray(key_indices),
        backend="sparse_interpret", **kw))
    got = propagate_labels(torch.from_numpy(feats), torch.from_numpy(labels0),
                           key_indices, **kw).numpy()
    return got, want


@pytest.mark.parametrize("H,W,radius,topk,seed,n_long,n_context", [
    (9, 12, 3.0, 5, 0, 1, 3),    # off-tile shape: partial tile row/column
    (8, 8, 6.0, 3, 0, 1, 3),     # window covers the whole frame
    (16, 11, 4.0, 7, 0, 1, 3),   # two tile rows
    (9, 12, 3.0, 4, 1, 2, 2),    # n_long=2: the delayed second anchor
    (13, 10, 5.0, 4, 4, 1, 3),   # odd radius 5
    (13, 10, 2.0, 4, 4, 1, 3),   # odd radius 2
])
def test_propagation_matches_pallas_interpret(H, W, radius, topk, seed,
                                              n_long, n_context):
    N_targets, C = (6, 8) if n_long == 2 else (5, 8)
    n_lbl = 3 if n_long == 2 else 4
    feats, labels0 = _setup(seed, n_context, N_targets, C, H, W, n_lbl)
    key_indices = context_index_bank(n_context, list(range(n_long)), N_targets)
    got, want = _both(feats, labels0, key_indices, n_context=n_context,
                      n_long=n_long, topk=topk,
                      temperature=0.05 if n_long == 2 else 0.07,
                      radius=radius)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("C", [1024, 2048])
def test_wide_features_match_pallas_interpret(C):
    """ResNet-50's feature widths (1024 without layer4, 2048 with it),
    which the CUDA kernel takes with its query tile streamed: the plain
    version against the Pallas kernel in interpret mode on small frames,
    the tolerance above."""
    n_context, N_targets, H, W = 3, 4, 9, 12
    feats, labels0 = _setup(3, n_context, N_targets, C, H, W, 4)
    key_indices = context_index_bank(n_context, [0], N_targets)
    got, want = _both(feats, labels0, key_indices, n_context=n_context,
                      n_long=1, topk=5, temperature=0.05, radius=4.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert ps.sparse_supported(C, 10, 4, 12.0) and ps.streams_query(
        C, 10, 12.0)


def test_first_target_is_ground_truth():
    H, W = 8, 8
    n_context, N_targets, C, n_lbl = 3, 4, 8, 4
    feats, labels0 = _setup(2, n_context, N_targets, C, H, W, n_lbl)
    key_indices = context_index_bank(n_context, [0], N_targets)
    got = propagate_labels(torch.from_numpy(feats), torch.from_numpy(labels0),
                           key_indices, n_context=n_context, n_long=1, topk=3,
                           temperature=0.07, radius=6.0).numpy()
    np.testing.assert_allclose(got[0], labels0[0], rtol=1e-6, atol=1e-7)


def test_context_index_bank_matches_jax():
    from videowalk_tpu.eval.propagation import context_index_bank as jax_bank

    for n_context, long_mem, N in ((20, [0], 40), (2, [0, 1], 6), (3, [], 5)):
        np.testing.assert_array_equal(
            context_index_bank(n_context, long_mem, N),
            jax_bank(n_context, long_mem, N))


def test_forced_ties_go_to_the_lowest_candidate():
    """Quantized features make many logits exactly equal; the selection
    must keep the earliest candidates (long frame raster first, then short
    frames in slot order), as the Pallas kernel's first-occurrence rule
    does. Labels are distinct per (frame, cell), so a different tie choice
    changes the prediction."""
    H, W, C, n_context, N_targets = 8, 8, 4, 2, 3
    rng = np.random.RandomState(7)
    N = n_context + N_targets
    feats = rng.randint(0, 2, (N, C, H, W)).astype(np.float32)
    feats[:, 0] = 1.0                                   # no zero vectors
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    n_lbl = 5
    labels0 = rng.rand(N, H, W, n_lbl).astype(np.float32)
    key_indices = context_index_bank(n_context, [0], N_targets)
    got, want = _both(feats, labels0, key_indices, n_context=n_context,
                      n_long=1, topk=6, temperature=0.1, radius=3.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # and the rule itself: one query whose every candidate ties
    f = torch.ones((3, 2, 2, 4)) / 2.0
    lab = torch.arange(3 * 4, dtype=torch.float32).reshape(3, 2, 2, 1)
    ctx = torch.tensor([0, 1], dtype=torch.int32)
    pred = ps.prop_sparse(f, lab, ctx, 2, n_long=1, topk=3, temperature=1.0,
                          radius=2.0)
    # the first 3 candidates are frame 0's cells 0, 1, 2: labels 0, 1, 2
    np.testing.assert_allclose(pred.numpy()[:, 0], np.full(4, 1.0), atol=1e-6)


def test_valid_pairs_counts_the_disk():
    """The bound's pair count equals a brute-force count."""
    H, W, radius = 9, 13, 3.5
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    yy, xx = yy.ravel(), xx.ravel()
    d2 = (yy[:, None] - yy[None]) ** 2 + (xx[:, None] - xx[None]) ** 2
    brute = 2 * (H * W) ** 2 + 3 * int((d2 < radius ** 2).sum())
    assert ps.valid_pairs(H, W, radius, n_long=2, n_short=3) == brute


def test_gate_follows_shared_memory():
    """The gate is the source's shared-memory budget (``smem_bytes`` mirrors
    ``prop_sparse_smem_bytes``) and its halo is the disk's reach. Past C =
    576 (k = 10, r = 12) the query tile streams, so every width fits."""
    assert ps.sparse_supported(256, 10, 4, 12.0)      # DAVIS
    assert ps.sparse_supported(512, 10, 4, 12.0)      # layer4 kept
    assert ps.sparse_supported(512, 32, 4, 12.0)
    for c in (1024, 2048):                            # ResNet-50
        assert ps.sparse_supported(c, 10, 4, 12.0)
        assert ps.sparse_supported(c, 32, 20, 12.0)
    # DAVIS: the query tile, two stages of 256 keys x 32 channels, the
    # lists of 10, two chunks' key cells, offsets and slots, eight warps'
    # scratch, 8 + 2 * 11 union rows, two counters
    assert ps.smem_bytes(256, 10, 12.0) == (4 * (64 * 256 + 2 * 256 * 32)
                                            + 64 * 10 * 8 + 2 * 256 * 12
                                            + 8 * 64 * 4 + 30 * 16 + 16)
    assert ps.smem_bytes(20, 10, 12.0) == ps.smem_bytes(32, 10, 12.0)
    assert ps.sparse_supported(576, 10, 4, 12.0)
    assert not ps.streams_query(576, 10, 12.0)          # the resident tile
    assert ps.sparse_supported(608, 10, 4, 12.0)
    assert ps.streams_query(608, 10, 12.0)
    # streamed: two stages of 64 queries x 32 channels, whatever C is
    assert ps.smem_bytes(1024, 10, 12.0) == ps.smem_bytes(2048, 10, 12.0) \
        == (4 * (2 * 64 * 32 + 2 * 256 * 32) + 64 * 10 * 8 + 2 * 256 * 12
            + 8 * 64 * 4 + 30 * 16 + 16)
    assert not ps.sparse_supported(254, 10, 4, 12.0)   # rows not 16 bytes
    assert not ps.sparse_supported(256, 33, 4, 12.0)   # k past the kernel's bound
    assert (ps.sparse_halo(12.0), ps.sparse_halo(12.5), ps.sparse_halo(5.5),
            ps.sparse_halo(1.0), ps.sparse_halo(0.0)) == (11, 12, 5, 0, 0)
    assert len(ps.disk_union_offsets(12.0)) == 808     # DAVIS's window: 30 x 30


@pytest.mark.parametrize("radius", [5.5, 12.0, 12.5, 1.0, 0.5])
@pytest.mark.parametrize("tile", [8, 4, 1])
def test_disk_union_offsets_match_brute_force(radius, tile):
    """The kernel's short-frame candidates of a query tile: every offset
    that some query of the tile takes under the exact f32 disk, in row-major
    order, each once, and no other; all inside the halo."""
    reach = int(np.ceil(radius)) + 2
    r2 = np.float32(radius * radius)
    want = [(oy, ox)
            for oy in range(-reach, tile + reach)
            for ox in range(-reach, tile + reach)
            if any(np.float32((oy - qy) ** 2 + (ox - qx) ** 2) < r2
                   for qy in range(tile) for qx in range(tile))]
    got = ps.disk_union_offsets(radius, tile)
    assert got.shape == (len(want), 2)
    assert [tuple(map(int, o)) for o in got] == want
    rr = ps.sparse_halo(radius)
    assert np.abs(got - (tile - 1) / 2).max() <= rr + (tile - 1) / 2
