"""The block-sparse top-k propagation CUDA kernel
(``videowalk_tpu_torch/ops/csrc/prop_sparse.cu``, f32 FMAs) against its plain
version (``prop_sparse_plain``) on the card
(``-m cuda``; skipped where there is no card), and the wrapper's refusals.
No JAX here, so the file runs with ``--noconftest`` where JAX is not
installed.

Tolerances: with exactly representable features (entries 0 or 1/2 in
four of eight channels, so every dot product and every logit is exact)
ties are exact on both sides and the kept candidates must be the same:
predictions within 1e-6 (the softmax's f32 sums in another order). With
random unit features the dots are f32 sums in another order than cuBLAS's:
1e-4."""

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.eval.propagation import context_index_bank
from videowalk_tpu_torch.ops import prop_sparse as ps

torch.set_num_threads(1)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _random(N, H, W, C, n_lbl, seed):
    rng = np.random.RandomState(seed)
    f = rng.randn(N, H, W, C).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    lab = rng.rand(N, H, W, n_lbl).astype(np.float32)
    return torch.from_numpy(f), torch.from_numpy(lab)


def _tied(N, H, W, n_lbl, seed):
    """Unit rows of 8 channels with exactly four set to 1/2: every dot is
    a multiple of 1/4, exact in f32, so candidates tie exactly
    and often; labels distinct per (frame, cell)."""
    rng = np.random.RandomState(seed)
    order = rng.rand(N, H, W, 8).argsort(-1)
    f = (order < 4).astype(np.float32) * 0.5
    lab = rng.rand(N, H, W, n_lbl).astype(np.float32)
    return torch.from_numpy(f), torch.from_numpy(lab)


def _run_targets(feats, lab, n_context, long_mem, n_targets, **kw):
    """Kernel and plain version target by target, each reading the same
    buffer with the kernel's earlier predictions written back; the largest
    difference."""
    feats, lab = feats.cuda(), lab.cuda()
    rows = context_index_bank(n_context, long_mem, n_targets)
    H, W, nl = lab.shape[1:]
    worst = 0.0
    for i in range(n_targets):
        t = int(rows[i, -1]) + 1
        ctx = torch.from_numpy(rows[i]).cuda()
        got = ps.prop_sparse(feats, lab, ctx, t, n_long=len(long_mem), **kw)
        want = ps.prop_sparse_plain(feats, lab, ctx, t, n_long=len(long_mem),
                                    **kw)
        torch.cuda.synchronize()
        assert got.shape == (H * W, nl) and torch.isfinite(got).all()
        worst = max(worst, float((got - want).abs().max()))
        lab[t] = got.view(H, W, nl)
    return worst


def test_wrapper_refuses_other_devices_and_shapes():
    f = torch.zeros((3, 8, 8, 8), device="meta")
    ctx = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ps.prop_sparse(f, f[..., :2], ctx, 2, n_long=1, topk=3,
                       temperature=0.1, radius=3.0)
    assert not ps.sparse_supported(8, 0, 2, 3.0)
    assert not ps.sparse_supported(6, 3, 2, 3.0)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,radius,topk,n_long,n_context", [
    (8, 8, 32, 6.0, 3, 1, 3),       # one tile, the union past the frame
    (17, 21, 20, 5.5, 5, 1, 4),     # ragged tiles; a channel tail in a step
    (30, 45, 64, 12.0, 10, 1, 3),   # DAVIS's radius: unions of 808 cells;
                                    # 256-key chunks across frames
    (24, 40, 36, 12.5, 7, 2, 2),    # two long frames, halo 12
    (16, 24, 256, 4.0, 32, 1, 3),   # k = 32
    (16, 16, 512, 3.0, 10, 0, 3),   # C = 512, no long frame
    (9, 12, 8, 0.5, 4, 1, 2),       # a disk of one cell
])
def test_kernel_matches_plain_on_card(H, W, C, radius, topk, n_long,
                                      n_context):
    _need_card()
    N_targets = 3
    feats, lab = _random(n_context + N_targets, H, W, C, 3, seed=C + H)
    before = ps.prop_sparse.launches
    err = _run_targets(feats, lab, n_context, list(range(n_long)), N_targets,
                       topk=topk, temperature=0.07, radius=radius)
    assert ps.prop_sparse.launches == before + N_targets
    assert err <= 1e-4, err


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,n_lbl", [
    (40, 40, 256, 16),      # JHMDB at cropSize 320: 15 joints + background
    (13, 19, 64, 16),       # ragged tiles
    (30, 45, 256, 20),      # VIP's 20 classes
    (17, 21, 32, 20),
])
def test_kernel_matches_plain_at_pose_and_parsing_label_widths(H, W, C,
                                                               n_lbl):
    """The eval's other label widths: 16 (JHMDB) and 20 (VIP) channels."""
    _need_card()
    feats, lab = _random(4 + 3, H, W, C, n_lbl, seed=n_lbl + H)
    before = ps.prop_sparse.launches
    err = _run_targets(feats, lab, 4, [0], 3, topk=10, temperature=0.05,
                       radius=12.0)
    assert ps.prop_sparse.launches == before + 3
    assert err <= 1e-4, err


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,radius,topk", [
    (8, 8, 3.0, 6), (13, 19, 5.5, 10), (24, 24, 12.0, 32)])
def test_forced_ties_go_to_the_lowest_candidate_on_card(H, W, radius, topk):
    """Exact ties everywhere: the kernel keeps the same candidates as the
    plain version's stable sorts (earliest id first), whichever lane holds
    a tied candidate."""
    _need_card()
    feats, lab = _tied(2 + 3, H, W, 5, seed=H * W)
    err = _run_targets(feats, lab, 2, [0], 3, topk=topk, temperature=0.5,
                       radius=radius)
    assert err <= 1e-6, err
    # one query whose every candidate ties: the first k of frame 0's raster
    f = torch.full((3, 2, 2, 8), 0.5).cuda() * (torch.arange(8) < 4).cuda()
    lab = torch.arange(12, dtype=torch.float32).reshape(3, 2, 2, 1).cuda()
    ctx = torch.tensor([0, 1], dtype=torch.int32).cuda()
    pred = ps.prop_sparse(f, lab, ctx, 2, n_long=1, topk=3, temperature=1.0,
                          radius=2.0)
    np.testing.assert_allclose(pred.cpu().numpy()[:, 0], np.full(4, 1.0),
                               atol=1e-6)


@pytest.mark.cuda
def test_kernel_repeats_bitwise_on_card():
    """Fixed-order sums and insertions: two launches are bitwise equal."""
    _need_card()
    feats, lab = _random(6, 30, 45, 64, 4, seed=3)
    feats, lab = feats.cuda(), lab.cuda()
    ctx = torch.tensor([0, 3, 4], dtype=torch.int32).cuda()
    kw = dict(n_long=1, topk=10, temperature=0.05, radius=12.0)
    first = ps.prop_sparse(feats, lab, ctx, 5, **kw)
    assert torch.equal(first, ps.prop_sparse(feats, lab, ctx, 5, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,radius", [
    (30, 45, 1024, 12.0),   # ResNet-50 without layer4; DAVIS's radius
    (17, 21, 2048, 5.5),    # with layer4; ragged tiles
    (16, 24, 612, 4.0),     # just past the resident tile; a channel tail
])
def test_kernel_matches_plain_with_the_query_tile_streamed(H, W, C, radius):
    """Widths whose query tile does not fit one block (``streams_query``):
    random unit features within 1e-4 of the plain version, and exact ties
    (four channels at 1/2 among C) to the same candidates within 1e-6."""
    _need_card()
    assert ps.streams_query(C, 10, radius)
    feats, lab = _random(3 + 3, H, W, C, 4, seed=C)
    before = ps.prop_sparse.launches
    err = _run_targets(feats, lab, 3, [0], 3, topk=10, temperature=0.05,
                       radius=radius)
    assert ps.prop_sparse.launches == before + 3
    assert err <= 1e-4, err
    tied, lab = _tied(3 + 3, H, W, 5, seed=C)
    wide = torch.zeros(tied.shape[:3] + (C,))
    wide[..., :: C // 8][..., :8] = tied
    err = _run_targets(wide, lab, 3, [0], 3, topk=10, temperature=0.5,
                       radius=radius)
    assert err <= 1e-6, err


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,n_dev", [
    (60, 107, 256, 3),     # DAVIS-480p's grid, 8 tile rows over 3 devices
    (61, 20, 1024, 2),     # a partial last row; the query tile streamed
    (20, 33, 64, 8),       # 3 tile rows over 8 devices
])
def test_kernel_bands_are_the_whole_frame_bitwise_on_card(H, W, C, n_dev):
    """``rows=(row0, n_rows)``: each band's launch covers its tile rows
    alone and gives the whole-frame launch's bits for them; propagation
    over ``[cuda] * n_dev`` equals the unbanded one bitwise, one launch a
    band a target."""
    from videowalk_tpu_torch.eval.propagation import propagate_labels

    _need_card()
    feats, lab = _random(4 + 3, H, W, C, 5, seed=H)
    feats, lab = feats.cuda(), lab.cuda()
    ctx = torch.tensor([0, 2, 3, 4], dtype=torch.int32).cuda()
    kw = dict(n_long=1, topk=10, temperature=0.05, radius=12.0)
    whole = ps.prop_sparse(feats, lab, ctx, 5, **kw)
    bands = ps.sparse_bands(H, n_dev)
    for row0, n_rows in bands:
        part = ps.prop_sparse(feats, lab, ctx, 5, rows=(row0, n_rows), **kw)
        y0, y1 = row0 * ps.TQ, min(H, (row0 + n_rows) * ps.TQ)
        assert torch.equal(part, whole[y0 * W:y1 * W])
    f = feats.permute(0, 3, 1, 2)
    idx = context_index_bank(4, [0], 3)
    pk = dict(n_context=4, n_long=1, topk=10, temperature=0.05, radius=12.0)
    want = propagate_labels(f, lab.cpu(), idx, **pk)
    before = ps.prop_sparse.launches
    got = propagate_labels(f, lab.cpu(), idx, devices=["cuda"] * n_dev, **pk)
    assert ps.prop_sparse.launches == before + 3 * len(bands)
    assert torch.equal(got, want)
