"""The port's Sinkhorn-Knopp paths against the JAX package:
``core/sinkhorn.py::sinkhorn_knopp``, ``stoch_mat(do_sinkhorn=True)`` and
``sk_targets_walk_loss`` (``core/walk.py``), and the CRW route of
``sk_targets``.

Tolerances: Sinkhorn outputs rtol 1e-4, atol 1e-6 (as
``tests/test_core_walk.py::test_sinkhorn_matches_torch_oracle``); losses
rtol 1e-4; accuracies the same count of hits (the argmax targets agree)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu.core import walk as jw
from videowalk_tpu.core.sinkhorn import sinkhorn_knopp as jax_sinkhorn
from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig

from videowalk_tpu_torch.core import walk as tw
from videowalk_tpu_torch.core.sinkhorn import sinkhorn_knopp
from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.models.crw import fused_walk_route
from videowalk_tpu_torch.ops import walk as walk_ops
from videowalk_tpu_torch.utils.checkpoint import state_from_flax

torch.set_num_threads(1)

TEMP = 0.05
SK_TOL = dict(rtol=1e-4, atol=1e-6)


def _q(B, C, T, N, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, C, T, N).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("tol,max_iter", [(0.01, 1000), (1e-4, 7), (0.01, 0)])
def test_sinkhorn_single_matrix_matches_jax(tol, max_iter):
    """One (6, 5) matrix; ``max_iter`` 0 still takes one iteration."""
    A = np.exp(2 * np.random.RandomState(0).randn(6, 5)).astype(np.float32)
    got = sinkhorn_knopp(torch.from_numpy(A), tol=tol, max_iter=max_iter)
    want = np.asarray(jax_sinkhorn(jnp.asarray(A), tol=tol, max_iter=max_iter))
    np.testing.assert_allclose(got.numpy(), want, **SK_TOL)


def test_sinkhorn_batch_stops_on_one_std_over_the_batch():
    """A batch of a mildly peaked matrix (its column sums settle in a few
    iterations) and a sharply peaked one (many): the stop test is one std
    over the column sums of both, as in the JAX package, so the first takes
    the second's iterations. Alone it stops early and ends 2e-3 away, so a
    per-matrix stop fails this test."""
    rng = np.random.RandomState(1)
    A = np.stack([np.exp(0.3 * rng.randn(5, 5)),
                  np.exp(4.0 * rng.randn(5, 5))]).astype(np.float32)
    got = sinkhorn_knopp(torch.from_numpy(A), tol=0.01, max_iter=200)
    want = np.asarray(jax_sinkhorn(jnp.asarray(A), tol=0.01, max_iter=200))
    np.testing.assert_allclose(got.numpy(), want, **SK_TOL)
    alone = sinkhorn_knopp(torch.from_numpy(A[:1]), tol=0.01, max_iter=200)
    assert np.abs(alone.numpy()[0] - want[0]).max() > 1e-3


@pytest.mark.parametrize("zero_diagonal", [False, True])
def test_stoch_mat_sinkhorn_matches_jax(zero_diagonal):
    rng = np.random.RandomState(2)
    A = rng.randn(3, 7, 7).astype(np.float32) * 0.5
    got = tw.stoch_mat(torch.from_numpy(A), 0.3, do_sinkhorn=True,
                       zero_diagonal=zero_diagonal)
    want = np.asarray(jw.stoch_mat(jnp.asarray(A), 0.3, do_sinkhorn=True,
                                   zero_diagonal=zero_diagonal))
    np.testing.assert_allclose(got.numpy(), want, **SK_TOL)


def _assert_sk_loss(loss, diags, loss_j, diags_j):
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-4)
    assert set(diags) == set(diags_j)
    for k, v in diags_j.items():
        # accuracies: the same count of hits (the means may part by one
        # f32 rounding)
        np.testing.assert_allclose(float(diags[k].detach()), float(v),
                                   rtol=1e-6 if k.startswith("acc") else 1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("use_zero_softmax", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 5, 9), (3, 32, 4, 16)])
def test_sk_targets_walk_loss_matches_jax(shape, use_zero_softmax):
    """Rate 0: loss, per-cycle cross-entropies and accuracies, and the
    gradient wrt q (atol 2e-5 of its largest entry, as
    ``tests/test_torch_walk.py``)."""
    q = _q(*shape, seed=sum(shape))
    kw = dict(use_zero_softmax=use_zero_softmax)
    (loss_j, diags_j), g_j = jax.value_and_grad(
        lambda v: jw.sk_targets_walk_loss(v, TEMP, **kw), has_aux=True)(
            jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_()
    loss, diags = tw.sk_targets_walk_loss(qt, TEMP, **kw)
    loss.backward()
    _assert_sk_loss(loss, diags, loss_j, diags_j)
    assert all(k.startswith(("xent sk", "acc sk")) for k in diags)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(qt.grad.numpy(), g_j, rtol=0,
                               atol=2e-5 * np.abs(g_j).max())


def test_sk_targets_walk_loss_given_mask_matches_jax(monkeypatch):
    """Edge dropout with one given mask ``m12`` ``(B, S, N, N)`` on the
    forward logits; the JAX function's keyed draw is replaced by the same
    mask (in its (S, B, N, N) layout) for this test."""
    B, C, T, N = 2, 16, 5, 9
    q = _q(B, C, T, N, seed=3)
    rng = np.random.RandomState(4)
    m12 = rng.rand(B, T - 1, N, N) < 0.2
    m21 = rng.rand(B, T - 1, N, N) < 0.2        # unused: forward logits only
    monkeypatch.setattr(jw, "edge_dropout", lambda key, A, rate: jnp.where(
        jnp.moveaxis(m12, 1, 0), jnp.asarray(-1e20, A.dtype), A))
    loss_j, diags_j = jw.sk_targets_walk_loss(
        jnp.asarray(q), TEMP, key=jax.random.PRNGKey(0), edgedrop_rate=0.2)
    loss, diags = tw.sk_targets_walk_loss(
        torch.from_numpy(q), TEMP, masks=(torch.from_numpy(m12),
                                          torch.from_numpy(m21)))
    _assert_sk_loss(loss, diags, loss_j, diags_j)
    undropped, _ = tw.sk_targets_walk_loss(torch.from_numpy(q), TEMP)
    assert float(undropped) != float(loss)


def test_sk_targets_walk_loss_draws_from_the_generator():
    q = torch.from_numpy(_q(2, 16, 5, 9, seed=5))
    a, _ = tw.sk_targets_walk_loss(
        q, TEMP, edgedrop_rate=0.2, generator=torch.Generator().manual_seed(1))
    b, _ = tw.sk_targets_walk_loss(
        q, TEMP, edgedrop_rate=0.2, generator=torch.Generator().manual_seed(1))
    assert float(a) == float(b) != float(tw.sk_targets_walk_loss(q, TEMP)[0])
    with pytest.raises(ValueError, match="Generator"):
        tw.sk_targets_walk_loss(q, TEMP, edgedrop_rate=0.2)
    for T in (1, 2):
        loss, diags = tw.sk_targets_walk_loss(
            torch.from_numpy(_q(2, 8, T, 5, 0)), TEMP)
        loss_j, diags_j = jw.sk_targets_walk_loss(
            jnp.asarray(_q(2, 8, T, 5, 0)), TEMP)
        assert float(loss) == float(loss_j) == 0.0 and diags == diags_j == {}


def test_crw_sk_targets_matches_jax_and_never_takes_the_fused_walk(
        monkeypatch):
    """``CRW(sk_targets=True)`` under ``fused_walk='auto'`` (ZeroSoftmax,
    a supported shape) takes ``sk_targets_walk_loss``, as the JAX model
    does: the train forward's loss and diagnostics equal JAX's (rate 0;
    q atol 1e-4). ``fused_walk='on'`` raises, as JAX's gate does."""
    jcfg = dict(model_type="scratch_zeropad",
                remove_layers=("layer3", "layer4"), temperature=TEMP,
                sk_targets=True)
    x = np.random.RandomState(6).randn(2, 4, 4, 32, 32, 3).astype(np.float32)
    jm = JaxCRW(JaxConfig(**jcfg))
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        lambda v: jm.init(jax.random.PRNGKey(0), v, train=False))(
            jnp.asarray(x))))
    (q_j, loss_j, diags_j), _ = jax.jit(lambda v: jm.apply(
        variables, v, train=True, mutable=["batch_stats"]))(jnp.asarray(x))

    cfg = CRWConfig(**jcfg)
    assert not fused_walk_route(cfg, T=4, N=4, C=128)
    assert fused_walk_route(CRWConfig(**{**jcfg, "sk_targets": False}),
                            T=4, N=4, C=128)

    def no_fused(*a, **k):
        raise AssertionError("sk_targets took the fused walk")

    monkeypatch.setattr(walk_ops, "fused_walk_loss", no_fused)
    model = CRW(cfg)
    model.load_state_dict(state_from_flax(variables), strict=True)
    with torch.no_grad():
        q, loss, diags = model(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=1e-4)
    _assert_sk_loss(loss, diags, loss_j, diags_j)
    assert "xent sk 1" in diags

    forced = CRW(CRWConfig(**jcfg, fused_walk="on"))
    with pytest.raises(ValueError, match="sk_targets"):
        forced(torch.from_numpy(x), train=False)
    with pytest.raises(ValueError, match="sk_targets"):
        fused_walk_route(CRWConfig(**jcfg, fused_walk="on"), T=4, N=4, C=128)
