"""The port's walk core (``videowalk_tpu_torch/core/walk.py``) against the
JAX package's ``videowalk_tpu/core/walk.py``: loss, diagnostics and the
gradient wrt q (``jax.grad``), on the same numpy inputs and masks.

Tolerances: losses rtol 1e-5 (f32 sums in another order); gradients atol
2e-5 of their largest entry (at T 0.05 the logits reach +-20, and the
chain of ZeroSoftmax products amplifies the f32 rounding of the
affinities)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu.core import walk as jw

from videowalk_tpu_torch.core import walk as tw

torch.set_num_threads(1)

TEMP = 0.05


def _q(B, C, T, N, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, C, T, N).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _masks(B, T, N, rate, seed):
    rng = np.random.RandomState(seed)
    return tuple((rng.rand(B, T - 1, N, N) < rate) for _ in range(2))


def _torch_loss_and_grad(q, **kw):
    qt = torch.from_numpy(q).requires_grad_()
    loss, diags = tw.crw_walk_loss(qt, TEMP, **kw)
    loss.backward()
    return (float(loss.detach()), {k: float(v.detach()) for k, v in diags.items()},
            qt.grad.numpy())


def _assert_grads(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_l2_normalize_zero_rows_have_zero_gradient():
    """The repaired fault: ``F.normalize`` gives ``g / 1e-12`` at an
    all-zero row; the port, like ``jax.grad`` of the JAX function, gives
    exactly 0 there."""
    x = np.array([[0.0, 0.0, 0.0, 0.0], [1.0, -2.0, 0.5, 3.0]], np.float32)
    g = np.array([[4.0, 5.0, 6.0, 7.0], [1.0, 2.0, 3.0, 4.0]], np.float32)
    want = jax.grad(lambda v: jnp.sum(jw.l2_normalize(v) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = tw.l2_normalize(xt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jw.l2_normalize(jnp.asarray(x))),
                               rtol=1e-6)
    assert np.all(xt.grad.numpy()[0] == 0.0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


VARIANTS = {
    "plain": dict(),
    "flip": dict(flip=True),
    "zero_diagonal": dict(zero_diagonal=True),
    "softmax": dict(use_zero_softmax=False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("shape", [(2, 16, 5, 9), (8, 128, 8, 49)],
                         ids=["small", "flagship"])
def test_crw_walk_loss_matches_jax(shape, variant):
    kw = VARIANTS[variant]
    q = _q(*shape, seed=sum(shape))

    def jax_loss(v):
        return jw.crw_walk_loss(v, TEMP, **kw)

    (l_j, d_j), g_j = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(q))
    l_t, d_t, g_t = _torch_loss_and_grad(q, **kw)
    np.testing.assert_allclose(l_t, float(l_j), rtol=1e-5)
    assert set(d_t) == set(d_j)
    for k in d_j:
        np.testing.assert_allclose(d_t[k], float(d_j[k]), rtol=1e-5,
                                   atol=1e-6)
    _assert_grads(g_t, np.asarray(g_j))


def test_short_clips_have_no_cycle():
    for T in (1, 2):
        loss, diags = tw.crw_walk_loss(torch.from_numpy(_q(2, 8, T, 5, 0)),
                                       TEMP)
        j_loss, j_diags = jw.crw_walk_loss(jnp.asarray(_q(2, 8, T, 5, 0)),
                                           TEMP)
        assert float(loss) == float(j_loss) == 0.0 and diags == j_diags == {}


def _jax_loss_with_masks(q, m12, m21, flip=False):
    """The JAX package's own pieces composed with given masks (its
    ``edge_dropout`` draws them from a key): affinity -> -1e20 fill ->
    ZeroSoftmax of logits / T -> palindrome products -> cross-entropy."""
    As = jnp.moveaxis(jw.affinity(q[:, :, :-1], q[:, :, 1:]), 1, 0)
    AsT = jnp.swapaxes(As, -1, -2)
    As = jnp.where(jnp.moveaxis(m12, 1, 0), -1e20, As)
    AsT = jnp.where(jnp.moveaxis(m21, 1, 0), -1e20, AsT)
    A12s = jw.zero_softmax(As / TEMP)
    A21s = jw.zero_softmax(AsT / TEMP)
    AAs = jw.palindrome_products(A12s, A21s, flip=flip)
    losses, accs = jax.vmap(jw.walk_xent_loss)(AAs)
    return jnp.sum(losses) / AAs.shape[0], (losses, accs)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 5, 9), (8, 128, 8, 49)],
                         ids=["small", "flagship"])
def test_edge_dropout_with_given_masks_matches_jax(shape, flip):
    B, C, T, N = shape
    q = _q(*shape, seed=7)
    m12, m21 = _masks(B, T, N, 0.1, seed=8)
    (l_j, (losses_j, accs_j)), g_j = jax.value_and_grad(
        _jax_loss_with_masks, has_aux=True)(
            jnp.asarray(q), jnp.asarray(m12), jnp.asarray(m21), flip)
    l_t, d_t, g_t = _torch_loss_and_grad(
        q, masks=(torch.from_numpy(m12), torch.from_numpy(m21)), flip=flip)
    np.testing.assert_allclose(l_t, float(l_j), rtol=1e-5)
    tag = "l" if flip else "r"
    for i in range(T - 2):
        np.testing.assert_allclose(d_t[f"xent cyc {tag}{i + 1}"],
                                   float(losses_j[i]), rtol=1e-5)
        np.testing.assert_allclose(d_t[f"acc cyc {tag}{i + 1}"],
                                   float(accs_j[i]), atol=1e-6)
    _assert_grads(g_t, np.asarray(g_j))


def test_dropped_edges_get_zero_softmax_weight_one():
    """The -1e20 fill goes in before the divide by T: a dropped logit is
    -2e21, and ZeroSoftmax gives it (e^-inf - 1)^2 = 1 before the row
    normalization, as in the JAX package and the reference."""
    A = torch.zeros((1, 3, 3))
    mask = torch.zeros((1, 3, 3), dtype=torch.bool)
    mask[0, 0, 1] = True
    P = tw.stoch_mat(A, TEMP, mask=mask)
    np.testing.assert_allclose(P[0, 0].numpy(), [0.0, 1 / (1 + 1e-5), 0.0],
                               rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jw.zero_softmax(jnp.asarray([[0.0, -1e20, 0.0]]) / TEMP)),
        P[0, :1].numpy(), rtol=1e-6)


def test_dropout_masks_come_from_the_generator():
    shape = (4, 7, 49, 49)
    a = tw.dropout_masks(shape, 0.1, torch.Generator().manual_seed(3),
                         torch.device("cpu"))
    b = tw.dropout_masks(shape, 0.1, torch.Generator().manual_seed(3),
                         torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])             # one mask per direction
    rate = float(torch.cat([a[0], a[1]]).float().mean())
    assert abs(rate - 0.1) < 0.01
    with pytest.raises(ValueError, match="Generator"):
        tw.dropout_masks(shape, 0.1, None, torch.device("cpu"))


def test_palindrome_products_match_jax():
    rng = np.random.RandomState(11)
    A12 = rng.rand(4, 3, 6, 6).astype(np.float32)
    A21 = rng.rand(4, 3, 6, 6).astype(np.float32)
    for flip in (False, True):
        want = jw.palindrome_products(jnp.asarray(A12), jnp.asarray(A21),
                                      flip=flip)
        got = tw.palindrome_products(torch.from_numpy(A12),
                                     torch.from_numpy(A21), flip=flip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_sinkhorn_paths_raise_naming_the_roadmap():
    """These paths raised ``NotImplementedError`` naming ROADMAP.md until
    they were ported: the two calls that checked it now run and give the
    JAX package's values (held at more shapes by
    ``tests/test_torch_sinkhorn.py``)."""
    loss, diags = tw.sk_targets_walk_loss(torch.zeros(1, 2, 3, 4), TEMP)
    loss_j, diags_j = jw.sk_targets_walk_loss(jnp.zeros((1, 2, 3, 4)), TEMP)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    assert set(diags) == set(diags_j) == {"xent sk 1", "acc sk 1"}
    got = tw.stoch_mat(torch.zeros(1, 3, 3), TEMP, do_sinkhorn=True)
    want = jw.stoch_mat(jnp.zeros((1, 3, 3)), TEMP, do_sinkhorn=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("T,N,C,fused", [
    (8, 49, 128, True),          # the flagship patch step
    (4, 48, 128, True),          # the superpixel step of record
    (10, 128, 512, True),        # the gate's edge: the kernels won 4-6.5x
    (8, 64, 256, True),          # swept: the kernels won 5.6-8x
    (10, 64, 128, True),         # swept: the kernels won 3.6-10x
    (2, 49, 128, True),          # no cycle: either path returns 0
])
def test_auto_fused_walk_follows_the_measured_region(T, N, C, fused):
    """``fused_walk='auto'`` takes the fused kernels where the card's sweep
    found them faster than the core walk: every shape the kernels take
    (``ops/walk.py``); ``on`` forces them on any supported shape and
    ``off`` never takes them."""
    from videowalk_tpu_torch.models.crw import CRWConfig, fused_walk_route

    assert fused_walk_route(CRWConfig(), T, N, C) is fused
    assert fused_walk_route(CRWConfig(fused_walk="on"), T, N, C)
    assert not fused_walk_route(CRWConfig(fused_walk="off"), T, N, C)
    assert not fused_walk_route(CRWConfig(flip=True), T, N, C)
