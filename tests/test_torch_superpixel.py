"""The port's superpixel path against the JAX package: the pooling weights,
``image_to_nodes``, the whole forward with ``sp_mask`` (eval and train mode
with the same edge-drop masks), every parameter's gradient in f64, the
weight carrier, and the train step.

Frames are 64x64 (8x8 maps of the ``scratch`` ResNet-18, 8x8 pixel windows)
with Voronoi superpixel ids that use a different subset of the 12 node slots
in every frame, so each frame has absent slots (all-zero rows of q).

Tolerances (f32 unless said): weights atol 1e-6 (exact integer counts, one
f32 division); q atol 1e-4 and loss rtol 1e-4 (f32 convolutions by different
algorithms); gradients 3e-5 of each tensor's largest entry in f64 (the walk
runs in f32 on both sides, see tests/test_torch_train_step.py); two train
steps' losses rtol 1e-3 (the second follows an Adam update)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu.core import walk as jax_walk
from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig
from videowalk_tpu.models.crw import superpixel_pool_weights as jax_weights
from videowalk_tpu.parallel import (create_train_state as jax_create_state,
                                    make_optimizer as jax_make_optimizer,
                                    make_train_step as jax_make_train_step)

from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.models.crw import superpixel_pool_weights
from videowalk_tpu_torch.parallel import (create_train_state, make_optimizer,
                                          make_train_step)
from videowalk_tpu_torch.utils.checkpoint import state_from_flax

torch.set_num_threads(1)

SP, TEMP, RATE = 12, 0.05, 0.1


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def voronoi_ids(B, T, h, w, seed):
    """(B, T, h, w) int32 ids: per frame 6..9 random seed points, each
    carrying a distinct random slot of the ``SP``; the rest are absent."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[:h, :w]
    out = np.zeros((B, T, h, w), np.int32)
    for b in range(B):
        for t in range(T):
            n = rng.randint(6, 10)
            slots = rng.permutation(SP)[:n]
            py, px = rng.rand(n) * h, rng.rand(n) * w
            d = (ys[..., None] - py) ** 2 + (xs[..., None] - px) ** 2
            out[b, t] = slots[d.argmin(-1)]
    return out


def _inputs(h=64, seed=1, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 4, h, h, 3).astype(dtype),
            voronoi_ids(2, 4, h, h, seed + 1))


def _configs(dilate, **kw):
    cfg = dict(model_type="scratch", temperature=TEMP, max_sp_num=SP,
               dilate_superpixels=dilate, dilation_kernel_size=7, **kw)
    return JaxConfig(**cfg), cfg


def _jax_variables(jm, x, sp):
    return _np(dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32),
                            sp_mask=jnp.asarray(sp), train=False)))


def _jax_masks(key, shape_sbnn):
    """The masks ``core/walk.py::transition_matrices`` draws from ``key``,
    in the port's (B, S, N, N) layout."""
    k12, k21 = jax.random.split(key)
    return [torch.from_numpy(np.array(
        jax.random.uniform(k, shape_sbnn) < RATE).transpose(1, 0, 2, 3))
        for k in (k12, k21)]


def _jax_loss_fn(jm, variables, x, sp, key):
    """Train-mode loss with the edge-drop masks drawn from ``key``: the
    model's own nodes, then its walk loss (the XLA path off the TPU)."""
    def f(params):
        (q, _), upd = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x, sp_mask=sp, just_feats=True, train=True,
            mutable=["batch_stats"])
        loss, diags = jax_walk.crw_walk_loss(q, TEMP, key=key,
                                             edgedrop_rate=RATE)
        return loss, (q, diags, upd["batch_stats"])
    return f


@pytest.mark.parametrize("dilate", [False, True])
def test_pool_weights_match_jax(dilate):
    sp = voronoi_ids(2, 3, 64, 64, seed=0)
    kw = dict(dilate=dilate, dilation_kernel_size=7)
    want = np.asarray(jax_weights(jnp.asarray(sp), SP, (8, 8), **kw))
    for dtype in (torch.int32, torch.int64):
        got = superpixel_pool_weights(torch.from_numpy(sp).to(dtype), SP,
                                      (8, 8), **kw)
        assert got.shape == (2, 3, 8, 8, SP) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    cols = got.sum((2, 3)).numpy()
    present = np.stack([[np.isin(np.arange(SP), sp[b, t]) for t in range(3)]
                        for b in range(2)])
    assert 0 < present.sum() < present.size
    np.testing.assert_allclose(cols[present], 1.0, atol=1e-6)
    assert (cols[~present] == 0).all()


def test_pool_weights_refuse_ids_that_do_not_tile():
    with pytest.raises(ValueError, match="do not tile"):
        superpixel_pool_weights(torch.zeros((1, 1, 30, 32), dtype=torch.int64),
                                SP, (4, 4))


@pytest.mark.parametrize("dilate", [False, True])
def test_forward_eval_matches_jax(dilate):
    """``train=False``: q (with exact zeros in the absent slots), maps'
    shape, loss and diagnostics, the walk on the core path on both sides
    (``fused_walk='off'``; the fused walk is held below)."""
    jcfg, cfg = _configs(dilate, fused_walk="off")
    x, sp = _inputs()
    jm = JaxCRW(jcfg)
    variables = _jax_variables(jm, x, sp)
    q_j, loss_j, diags_j = jax.jit(lambda v: jm.apply(
        v, x, sp_mask=sp, train=False))(variables)
    model = CRW(CRWConfig(**cfg))
    model.load_state_dict(state_from_flax(variables), strict=True)
    with torch.no_grad():
        q, loss, diags = model(torch.from_numpy(x),
                               sp_mask=torch.from_numpy(sp), train=False)
        q2, maps = model(torch.from_numpy(x),
                         sp_mask=torch.from_numpy(sp).long(),
                         just_feats=True, train=False)
    assert q.shape == (2, 128, 4, SP) and maps.shape == (2, 4, 8, 8, 512)
    assert torch.equal(q, q2)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=1e-4)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    for k, v in diags_j.items():
        np.testing.assert_allclose(float(diags[k]), float(v), rtol=1e-4,
                                   atol=1e-5)
    absent = ~np.stack([[np.isin(np.arange(SP), sp[b, t]) for t in range(4)]
                        for b in range(2)])                     # (B, T, SP)
    assert absent.any(-1).all()
    qa = q.permute(0, 2, 3, 1).numpy()                          # (B, T, SP, C)
    assert (qa[absent] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(qa[~absent], axis=-1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("dilate", [False, True])
def test_forward_train_matches_jax_with_the_same_masks(dilate):
    """``train=True`` (BN batch statistics) with edge dropout 0.1: the port
    takes the masks JAX draws from its key, and its default fused walk (the
    plain version on the CPU) against JAX's core walk. Running statistics
    atol 1e-4 of their scale. The accuracies are left out: an absent slot's
    row of a cycle product is all equal, which the fused walk counts as
    correct (``diag >= rowmax``, as the JAX package's fused kernel does) and
    the core walk's argmax counts for row 0 only."""
    jcfg, cfg = _configs(dilate, edgedrop_rate=RATE)
    x, sp = _inputs()
    jm = JaxCRW(jcfg)
    variables = _jax_variables(jm, x, sp)
    key = jax.random.PRNGKey(7)
    loss_j, (q_j, diags_j, stats_j) = jax.jit(
        _jax_loss_fn(jm, variables, x, sp, key))(variables["params"])
    model = CRW(CRWConfig(**cfg))
    model.load_state_dict(state_from_flax(variables), strict=True)
    with torch.no_grad():
        q, loss, diags = model(torch.from_numpy(x),
                               sp_mask=torch.from_numpy(sp), train=True,
                               walk_masks=_jax_masks(key, (3, 2, SP, SP)))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=1e-4)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    assert set(diags) == set(diags_j)
    for k, v in diags_j.items():
        if k.startswith("xent"):
            np.testing.assert_allclose(float(diags[k]), float(v), rtol=1e-4,
                                       atol=1e-5)
    state = model.state_dict()
    for k, v in state_from_flax({"batch_stats": _np(stats_j)}).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(
                state[k].numpy(), v.numpy(), rtol=0,
                atol=1e-4 * max(1.0, float(v.abs().max())), err_msg=k)


@pytest.mark.parametrize("dilate", [False, True])
def test_grads_match_jax_in_float64(dilate):
    """Every parameter's gradient of the train-mode superpixel loss with
    edge dropout (the same masks), the port in f64 against ``jax.grad``
    under x64, 32x32 frames (4x4 maps). 3e-5 of each tensor's largest
    entry: both sides run the walk in f32 on the f64 embeddings, and JAX
    pools f32-cast maps."""
    jcfg, cfg = _configs(dilate, edgedrop_rate=RATE, fused_walk="off")
    x, sp = _inputs(h=32, dtype=np.float64)
    variables = _jax_variables(JaxCRW(jcfg), x, sp)
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        jm = JaxCRW(JaxConfig(dtype=jnp.float64, **cfg))
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        grads_j = _np(jax.jit(jax.grad(
            lambda p: _jax_loss_fn(jm, v64, jnp.asarray(x), jnp.asarray(sp),
                                   key)(p)[0]))(v64["params"]))
        masks = _jax_masks(key, (3, 2, SP, SP))     # x64 draws f64 uniforms
    grads = state_from_flax({"params": grads_j})
    model = CRW(CRWConfig(dtype=torch.float64, **cfg))
    model.load_state_dict(state_from_flax(variables), strict=True)
    model.double()
    q, loss, _ = model(torch.from_numpy(x), sp_mask=torch.from_numpy(sp),
                       train=True, walk_masks=masks)
    assert q.dtype == torch.float64
    loss.backward()
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for k, g in grads.items():
        g = g.double().numpy()
        assert np.isfinite(params[k].grad.numpy()).all(), k
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=0,
                                   atol=3e-5 * np.abs(g).max(), err_msg=k)


def test_superpixel_config_adds_no_parameter():
    """A JAX model initialized on the superpixel path loads with
    ``strict=True`` into the port's superpixel config and into its patch
    config alike."""
    jcfg, cfg = _configs(True)
    x, sp = _inputs(h=32)
    state = state_from_flax(_jax_variables(JaxCRW(jcfg), x, sp))
    model = CRW(CRWConfig(**cfg))
    assert set(model.state_dict()) == set(state)
    model.load_state_dict(state, strict=True)
    CRW(CRWConfig(model_type="scratch")).load_state_dict(state, strict=True)


def test_train_step_with_sp_mask_matches_jax_steps():
    """Two steps on ``device='cpu'`` (dilated superpixels, edge dropout off,
    Adam 3e-4) against two JAX steps from the same weights: both losses
    rtol 1e-3; parameters and BN running statistics move; the mask must lie
    on the state's device."""
    jcfg, cfg = _configs(True)
    x, sp = _inputs()
    jm = JaxCRW(jcfg)
    tx = jax_make_optimizer(lr=3e-4)
    jstate = jax_create_state(jm, tx, jnp.asarray(x), jax.random.PRNGKey(0),
                              sp_mask=jnp.asarray(sp))
    variables = _np({"params": jstate.params,
                     "batch_stats": jstate.batch_stats})
    jstep = jax_make_train_step(jm, tx, with_sp_mask=True, donate=False)
    losses_j = []
    for i in range(2):
        jstate, metrics = jstep(jstate, jnp.asarray(x), jax.random.PRNGKey(i),
                                jnp.asarray(sp))
        losses_j.append(float(metrics["loss"]))

    model = CRW(CRWConfig(**cfg))
    model.load_state_dict(state_from_flax(variables), strict=True)
    state = create_train_state(model, make_optimizer(lr=3e-4), device="cpu")
    step = make_train_step()
    w0 = model.encoder.model.conv1.weight.detach().clone()
    rm0 = model.encoder.model.bn1.running_mean.clone()
    xt, spt = torch.from_numpy(x), torch.from_numpy(sp)
    metrics = [step(state, xt, None, sp_mask=spt) for _ in range(2)]
    assert state.step == 2
    np.testing.assert_allclose([float(m["loss"]) for m in metrics], losses_j,
                               rtol=1e-3)
    assert set(metrics[0]) == {"loss", "xent cyc r1", "acc cyc r1",
                               "xent cyc r2", "acc cyc r2"}
    assert not torch.equal(model.encoder.model.conv1.weight, w0)
    assert not torch.equal(model.encoder.model.bn1.running_mean, rm0)
    assert int(model.encoder.model.bn1.num_batches_tracked) == 2
    with pytest.raises(ValueError, match="sp_mask on meta"):
        step(state, xt, None, sp_mask=torch.zeros(sp.shape, device="meta",
                                                  dtype=torch.int32))


def test_image_to_nodes_refuses_bad_ids():
    model = CRW(CRWConfig(model_type="scratch", max_sp_num=SP))
    x = torch.zeros((1, 2, 32, 32, 3))
    with pytest.raises(ValueError, match="int32 or int64"):
        model(x, sp_mask=torch.zeros((1, 2, 32, 32)), train=False)
    with pytest.raises(ValueError, match="int32 or int64"):
        model(x, sp_mask=torch.zeros((1, 2, 16, 32), dtype=torch.int64),
              train=False)
