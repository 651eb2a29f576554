"""The fused walk (``videowalk_tpu_torch/ops/walk.py``): its plain PyTorch
forward/backward against the JAX package's fused walk ``_fused_walk``
(Pallas, interpret mode on the CPU) and against the port's own core loss
with autograd; a plain rendering of the kernels' phases (the recursions
split by row and column blocks, the cycles, steps and frames apart)
against both; its guards; and, on the card (``-m cuda``), the CUDA
kernels against the plain version and against themselves (two runs
bitwise equal).

Tolerances: losses rtol 1e-5, accuracies exact to 1e-6 (f32 sums in
another order; the diagonal-is-max test on identical products); dq atol
2e-5 of its largest entry (hand VJP vs autograd, f32, ZeroSoftmax chains
at T 0.05).

JAX is imported inside the tests that compare with it, so that the card
tests run where JAX is not installed (``--noconftest -m cuda``)."""

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.core import walk as tw
from videowalk_tpu_torch.ops import _build
from videowalk_tpu_torch.ops import walk as wk

torch.set_num_threads(1)

TEMP = 0.05


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(B, T, N, C, rate, seed):
    """q (B, T, N, C) unit rows, uint8 masks (B, S, N, N), upstream dl."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, N, C).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    m12, m21 = ((rng.rand(B, T - 1, N, N) < rate).astype(np.uint8)
                for _ in range(2))
    dl = rng.randn(B, T - 2).astype(np.float32)
    return q, m12, m21, dl


def _drop_slots(q, lo, hi, seed):
    """Zero ``lo..hi-1`` random node slots of every (b, t) frame of q
    (B, T, N, C), a different set per frame: the superpixel path's absent
    slots."""
    rng = np.random.RandomState(seed)
    B, T, N, _ = q.shape
    for b in range(B):
        for t in range(T):
            q[b, t, rng.permutation(N)[:rng.randint(lo, hi)]] = 0.0
    return q


def _assert_grads(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def _jax_fused_walk(q, m12, m21, dl):
    """JAX's ``_fused_walk`` (Pallas, interpret mode on the CPU) and its
    VJP for ``dl``: losses, accs, dq. JAX pads N and C to 128 lanes with
    zeros (padded nodes are unreachable under ZeroSoftmax, ``n_valid`` keeps
    them out of the loss); the port does not pad."""
    import jax
    import jax.numpy as jnp

    from videowalk_tpu.ops.walk_kernel import _fused_walk

    B, T, N, C = q.shape
    S, NP, CP = T - 1, 128, max(128, C)
    qp = np.zeros((B, T, NP, CP), np.float32)
    qp[:, :, :N, :C] = q
    mp = [np.zeros((B, S, NP, NP), np.uint8) for _ in range(2)]
    mp[0][:, :, :N, :N], mp[1][:, :, :N, :N] = m12, m21
    (l_j, a_j), vjp = jax.vjp(
        lambda v: _fused_walk(v, jnp.asarray(mp[0]), jnp.asarray(mp[1]),
                              TEMP, N), jnp.asarray(qp))
    dq_j = np.asarray(vjp((jnp.asarray(dl), jnp.zeros_like(a_j)))[0])
    return np.asarray(l_j), np.asarray(a_j), dq_j[:, :, :N, :C]


@pytest.mark.parametrize("B,T,N,C,rate", [
    (2, 4, 10, 16, 0.0), (2, 5, 13, 24, 0.1), (2, 8, 49, 128, 0.1)])
def test_plain_matches_jax_fused_walk(B, T, N, C, rate):
    """Same q and masks through JAX's fused walk and the plain version."""
    q, m12, m21, dl = _inputs(B, T, N, C, rate, seed=N + C)
    l_j, a_j, dq_j = _jax_fused_walk(q, m12, m21, dl)

    losses, accs, *res = wk.fused_walk_plain_fwd(
        torch.from_numpy(q), torch.from_numpy(m12), torch.from_numpy(m21),
        TEMP)
    dq = wk.fused_walk_plain_bwd(torch.from_numpy(q), *res,
                                 torch.from_numpy(dl), TEMP)
    np.testing.assert_allclose(losses.numpy(), l_j, rtol=1e-5)
    np.testing.assert_allclose(accs.numpy(), a_j, atol=1e-6)
    _assert_grads(dq.numpy(), dq_j)


def _phased_fwd(q, m12, m21, temp, blk):
    """The forward as ``csrc/walk.cu`` splits it, in plain torch: the
    affinities and ZeroSoftmax of every step at once; the F recursion run
    separately on each block of ``blk`` rows and the B recursion on each
    block of ``blk`` columns; the cycles apart."""
    B, T, N, _ = q.shape
    S = T - 1
    A = q[:, :-1] @ q[:, 1:].transpose(-1, -2)
    neg = torch.full_like(A, tw.NEG)
    d12 = torch.where(m12 != 0, neg, A) / temp
    d21 = torch.where(m21 != 0, neg, A.transpose(-1, -2)) / temp
    P, Q = tw.zero_softmax(d12), tw.zero_softmax(d21)
    f, b = P.clone(), Q.clone()                   # slot 0: F_0 = P_0, B_0 = Q_0
    for r0 in range(0, N, blk):
        rows = slice(r0, r0 + blk)
        v = P[:, 0, rows]
        for i in range(1, S):
            v = v @ P[:, i]                       # rows r of F_i: rows r of F_{i-1}
            f[:, i, rows] = v
    for c0 in range(0, N, blk):
        cols = slice(c0, c0 + blk)
        v = Q[:, 0, :, cols]
        for i in range(1, S):
            v = Q[:, i] @ v                       # columns of B_i: those of B_{i-1}
            b[:, i, :, cols] = v
    AA = f[:, 1:] @ b[:, 1:]                      # every cycle at once
    diag = torch.diagonal(AA, dim1=-2, dim2=-1)
    losses = (torch.log(AA.sum(-1) + N * tw.EPS)
              - torch.log(diag + tw.EPS)).mean(-1)
    accs = (diag >= AA.amax(-1)).float().mean(-1)
    return losses, accs, d12, d21, f, b, P, Q


def _phased_bwd(q, d12, d21, f, b, p, qz, dl, temp, blk):
    """The backward as ``csrc/walk.cu`` splits it, in plain torch: every
    cycle's dAA_i, X_i = dAA_i B_i^T and Y_i = F_i^T dAA_i at once; the dF
    recursion on blocks of ``blk`` rows and the dB recursion on blocks of
    ``blk`` columns, each storing dF_i, dB_i; every step's zsm VJP at once;
    dq per frame as dA_t q_{t+1} + dA_{t-1}^T q_{t-1}."""
    B, T, N, _ = q.shape
    S = T - 1
    eye = torch.eye(N, dtype=q.dtype)
    AA = f[:, 1:] @ b[:, 1:]
    rowsum = AA.sum(-1, keepdim=True) + N * tw.EPS
    dAA = (((AA + tw.EPS) / rowsum - eye) * (dl[..., None, None] / N)
           / (AA + tw.EPS))
    X = dAA @ b[:, 1:].transpose(-1, -2)          # X[:, i - 1] = X_i
    Y = f[:, 1:].transpose(-1, -2) @ dAA
    dF, dB = torch.empty_like(f), torch.empty_like(b)
    for r0 in range(0, N, blk):
        rows = slice(r0, r0 + blk)
        v = torch.zeros_like(X[:, 0, rows])
        for i in range(S - 1, 0, -1):
            v = v + X[:, i - 1, rows]
            dF[:, i, rows] = v
            v = v @ p[:, i].transpose(-1, -2)
        dF[:, 0, rows] = v
    for c0 in range(0, N, blk):
        cols = slice(c0, c0 + blk)
        v = torch.zeros_like(Y[:, 0, :, cols])
        for i in range(S - 1, 0, -1):
            v = v + Y[:, i - 1, :, cols]
            dB[:, i, :, cols] = v
            v = qz[:, i].transpose(-1, -2) @ v
        dB[:, 0, :, cols] = v
    dP = torch.cat([dF[:, :1], f[:, :-1].transpose(-1, -2) @ dF[:, 1:]], 1)
    dQ = torch.cat([dB[:, :1], dB[:, 1:] @ b[:, :-1].transpose(-1, -2)], 1)
    dA = (wk._zsm_bwd(d12, dP) / temp
          + (wk._zsm_bwd(d21, dQ) / temp).transpose(-1, -2))
    dq = torch.zeros_like(q)
    for t in range(T):
        if t < S:
            dq[:, t] = dA[:, t] @ q[:, t + 1]
        if t > 0:
            dq[:, t] = dq[:, t] + dA[:, t - 1].transpose(-1, -2) @ q[:, t - 1]
    return dq


@pytest.mark.parametrize("B,T,N,C,blk,absent", [
    (2, 3, 5, 8, 2, False), (2, 8, 49, 128, 8, False),
    (2, 5, 13, 24, 8, True)])
def test_phase_split_matches_plain_and_jax(B, T, N, C, blk, absent):
    """The kernels' decomposition (row and column blocks of ``blk``, which
    does not divide N) against the plain version, and through it against
    JAX's fused walk; with absent node slots (all-zero q rows) in the
    last case. Tolerances as above."""
    q, m12, m21, dl = _inputs(B, T, N, C, 0.1, seed=N + T)
    if absent:
        q = _drop_slots(q, 1, 5, seed=N)
    tq, t12, t21, tdl = (torch.from_numpy(a) for a in (q, m12, m21, dl))
    got = _phased_fwd(tq, t12, t21, TEMP, blk)
    want = wk.fused_walk_plain_fwd(tq, t12, t21, TEMP)
    got_dq = _phased_bwd(tq, *got[2:], tdl, TEMP, blk)
    want_dq = wk.fused_walk_plain_bwd(tq, *want[2:], tdl, TEMP)
    l_j, a_j, dq_j = _jax_fused_walk(q, m12, m21, dl)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    _assert_grads(got_dq.numpy(), want_dq.numpy())
    np.testing.assert_allclose(got[0].numpy(), l_j, rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), a_j, atol=1e-6)
    _assert_grads(got_dq.numpy(), dq_j)
    assert np.isfinite(got_dq.numpy()).all()


@pytest.mark.parametrize("shape,rate", [((2, 16, 5, 9), 0.0),
                                        ((2, 16, 5, 9), 0.2),
                                        ((8, 128, 8, 49), 0.1)])
def test_fused_loss_matches_core_loss_and_autograd(shape, rate):
    """The fused autograd Function (plain version on the CPU) against the
    core loss differentiated by autograd, with the same masks."""
    B, C, T, N = shape
    q, m12, m21, _ = _inputs(B, T, N, C, rate, seed=3)
    q = np.ascontiguousarray(q.transpose(0, 3, 1, 2))          # (B, C, T, N)
    masks = (torch.from_numpy(m12).bool(), torch.from_numpy(m21).bool())
    out = {}
    for name, fn in (("core", tw.crw_walk_loss), ("fused", wk.fused_walk_loss)):
        qt = torch.from_numpy(q).requires_grad_()
        loss, diags = fn(qt, TEMP, masks=masks)
        loss.backward()
        out[name] = (float(loss.detach()),
                     {k: float(v.detach()) for k, v in diags.items()},
                     qt.grad.numpy())
    np.testing.assert_allclose(out["fused"][0], out["core"][0], rtol=1e-5)
    assert set(out["fused"][1]) == set(out["core"][1])
    for k, v in out["core"][1].items():
        np.testing.assert_allclose(out["fused"][1][k], v, rtol=1e-5,
                                   atol=1e-6)
    _assert_grads(out["fused"][2], out["core"][2])


def test_fused_loss_with_absent_slots_matches_core_loss():
    """Rows and columns of exact zeros in q, a different set per frame: the
    fused plain version against the core loss and autograd; the gradient of
    an absent slot's row is finite."""
    q, m12, m21, _ = _inputs(2, 4, 12, 16, 0.1, seed=6)
    q = np.ascontiguousarray(_drop_slots(q, 1, 4, seed=7).transpose(0, 3, 1, 2))
    masks = (torch.from_numpy(m12).bool(), torch.from_numpy(m21).bool())
    out = {}
    for name, fn in (("core", tw.crw_walk_loss), ("fused", wk.fused_walk_loss)):
        qt = torch.from_numpy(q).requires_grad_()
        loss, _ = fn(qt, TEMP, masks=masks)
        loss.backward()
        out[name] = (float(loss.detach()), qt.grad.numpy())
    assert np.isfinite(out["fused"][1]).all()
    np.testing.assert_allclose(out["fused"][0], out["core"][0], rtol=1e-5)
    _assert_grads(out["fused"][1], out["core"][1])


def test_masks_from_generator_are_reproducible():
    q = torch.from_numpy(np.ascontiguousarray(
        _inputs(2, 5, 9, 16, 0.0, seed=4)[0].transpose(0, 3, 1, 2)))
    a = wk.fused_walk_loss(q, TEMP, edgedrop_rate=0.1,
                           generator=torch.Generator().manual_seed(5))[0]
    b = wk.fused_walk_loss(q, TEMP, edgedrop_rate=0.1,
                           generator=torch.Generator().manual_seed(5))[0]
    clean = wk.fused_walk_loss(q, TEMP)[0]
    assert float(a) == float(b) != float(clean)
    assert float(wk.fused_walk_loss(q[:, :, :2], TEMP)[0]) == 0.0


def test_gate():
    assert wk.walk_supported(8, 49, 128)
    assert wk.walk_supported(10, 128, 512) and wk.walk_supported(3, 1, 1)
    assert not wk.walk_supported(11, 49, 128)
    assert not wk.walk_supported(8, 129, 128)
    assert not wk.walk_supported(8, 49, 513)
    assert not wk.walk_supported(2, 49, 128)


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 4, 3, 8), device="meta")
    m = torch.zeros((1, 3, 3, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wk.walk_fwd(q, m, m, TEMP)
    r = torch.zeros((1, 3, 3, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wk.walk_bwd(q, *(r,) * 6, torch.zeros((1, 2), device="meta"), TEMP)


def test_fused_on_outside_the_gate_raises():
    from videowalk_tpu_torch.models import CRW, CRWConfig

    x = torch.zeros((1, 11, 2, 16, 16, 3))
    model = CRW(CRWConfig(model_type="scratch_zeropad", fused_walk="on",
                          remove_layers=("layer3", "layer4")))
    with pytest.raises(ValueError, match="clip_len > 10"):
        model(x, train=False)
    flip = CRW(CRWConfig(model_type="scratch_zeropad", fused_walk="on",
                         flip=True, remove_layers=("layer3", "layer4")))
    with pytest.raises(ValueError, match="fused_walk='on'"):
        flip(x[:, :4], train=False)
    auto = CRW(CRWConfig(model_type="scratch_zeropad", fused_walk="auto",
                         remove_layers=("layer3", "layer4")))
    _, loss, _ = auto(x, train=False)                # core path, no raise
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="fused_walk"):
        CRW(CRWConfig(fused_walk="maybe"))


@pytest.mark.cuda
def test_kernel_raises_without_its_library(monkeypatch, tmp_path):
    _need_card()
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    q, m12, m21, _ = _inputs(1, 4, 5, 8, 0.0, seed=0)
    with pytest.raises(RuntimeError, match="nvcc"):
        wk.walk_fwd(torch.from_numpy(q).cuda(), torch.from_numpy(m12).cuda(),
                    torch.from_numpy(m21).cuda(), TEMP)


# the tiles' edges: N across one to four lanes a row, the 32-row tiles and
# the recursions' 8-vector blocks, the shortest and longest clips, C across
# the 64-channel chunks and dq tiles (C = 1: the scalar q reads)
EDGE_SHAPES = [(2, T, N, C, 0.1) for N in (1, 13, 49, 64, 65, 101, 128)
               for T in (3, 10) for C in (1, 24, 128, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N,C,rate", [
    (2, 3, 1, 1, 0.0), (3, 5, 13, 24, 0.1), (8, 8, 49, 128, 0.1),
    (2, 6, 101, 40, 0.1), (2, 10, 128, 512, 0.1)] + EDGE_SHAPES)
def test_kernels_match_plain_on_card(B, T, N, C, rate):
    """Kernel vs plain version on the card, f32 (TF32 off). Tolerance as
    above: products summed in another order."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, m12, m21, dl = (torch.from_numpy(a).cuda()
                       for a in _inputs(B, T, N, C, rate, seed=T * N))
    want = wk.fused_walk_plain_fwd(q, m12, m21, TEMP)
    want_dq = wk.fused_walk_plain_bwd(q, *want[2:], dl, TEMP)
    f0, b0 = wk.walk_fwd.launches, wk.walk_bwd.launches
    got = wk.walk_fwd(q, m12, m21, TEMP)
    got_dq = wk.walk_bwd(q, *got[2:], dl, TEMP)
    torch.cuda.synchronize()
    assert (wk.walk_fwd.launches, wk.walk_bwd.launches) == (f0 + 1, b0 + 1)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               atol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
    _assert_grads(got_dq.cpu().numpy(), want_dq.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N,C,lo,hi", [(6, 4, 48, 128, 8, 15),
                                           (3, 5, 13, 24, 1, 13)])
def test_kernels_match_plain_with_absent_slots_on_card(B, T, N, C, lo, hi):
    """The superpixel step's walk: all-zero q rows (absent node slots), a
    different set per frame, at its shape of record (6, 4, 48, 128) with
    8-14 absent slots and at a small shape where a frame may keep a single
    node. Everything finite; tolerances as above."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, m12, m21, dl = _inputs(B, T, N, C, 0.1, seed=N)
    q = _drop_slots(q, lo, hi, seed=C)
    q, m12, m21, dl = (torch.from_numpy(a).cuda() for a in (q, m12, m21, dl))
    want = wk.fused_walk_plain_fwd(q, m12, m21, TEMP)
    want_dq = wk.fused_walk_plain_bwd(q, *want[2:], dl, TEMP)
    got = wk.walk_fwd(q, m12, m21, TEMP)
    got_dq = wk.walk_bwd(q, *got[2:], dl, TEMP)
    torch.cuda.synchronize()
    for t in (*got, got_dq, *want, want_dq):
        assert torch.isfinite(t).all()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               atol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
    _assert_grads(got_dq.cpu().numpy(), want_dq.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N,C", [(8, 8, 49, 128), (2, 10, 128, 512)])
def test_kernels_repeat_bitwise_on_card(B, T, N, C):
    """Two runs of the kernels on the same inputs give bitwise-equal
    losses, accuracies, residuals and dq: every sum has a fixed order and
    no atomics."""
    _need_card()
    q, m12, m21, dl = (torch.from_numpy(a).cuda()
                       for a in _inputs(B, T, N, C, 0.1, seed=N))
    runs = []
    for _ in range(2):
        out = wk.walk_fwd(q, m12, m21, TEMP)
        runs.append((*out, wk.walk_bwd(q, *out[2:], dl, TEMP)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
