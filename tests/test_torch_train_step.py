"""The port's training step against the JAX package: train-mode BatchNorm,
the CRW train forward (q, loss, diagnostics, new running statistics), its
gradients, the weight carrier on the full model, and the optimizer.

The JAX model's initial weights are carried by ``state_from_flax`` and
loaded with ``strict=True``; JAX gradients are mapped to the port's names
by the same function. Tolerances (f32 unless said): q and running
statistics atol 1e-4 and the loss rtol 1e-4 (f32 convolutions by different
algorithms; BN statistics over a few hundred values); gradients and bf16
looser, as stated at those tests."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax

from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig
from videowalk_tpu.parallel import make_optimizer as jax_make_optimizer

from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.models.resnet import BatchNorm
from videowalk_tpu_torch.parallel import (create_train_state, make_optimizer,
                                          make_train_step)
from videowalk_tpu_torch.utils.checkpoint import state_from_flax

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_semantics_match_flax(dtype):
    """Output, new running statistics (biased fast variance, decay 0.9) and
    gradients of one train-mode BN layer. bf16: output and dx within 2e-2
    of their scale (one bf16 rounding is 4e-3), statistics as in f32."""
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 5, 5, 8) * 3 + 1).astype(np.float32)      # NHWC
    g = rng.randn(6, 5, 5, 8).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(8)).astype(np.float32)
    bias = (0.1 * rng.randn(8)).astype(np.float32)
    ra_mean = rng.randn(8).astype(np.float32)
    ra_var = (rng.rand(8) + 0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jdt)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}

    def f(params, xx):
        y, upd = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          xx, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * g), (y, upd["batch_stats"])

    (_, (y_j, stats_j)), (gp_j, gx_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"],
                                         jnp.asarray(x).astype(jdt))

    m = BatchNorm(8, tdt)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(ra_mean))
        m.running_var.copy_(torch.from_numpy(ra_var))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).to(tdt).requires_grad_()
    y = m(xt, train=True)
    assert y.dtype == tdt
    (y.float() * torch.from_numpy(g.transpose(0, 3, 1, 2))).sum().backward()

    tol = 2e-2 if dtype == "bfloat16" else 1e-5

    def close(got, want):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * max(1.0, np.abs(want).max()))

    close(y.detach().float().numpy().transpose(0, 2, 3, 1), y_j)
    close(xt.grad.float().numpy().transpose(0, 2, 3, 1), gx_j)
    close(m.weight.grad.numpy(), gp_j["scale"])
    close(m.bias.grad.numpy(), gp_j["bias"])
    np.testing.assert_allclose(m.running_mean.numpy(), stats_j["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), stats_j["var"],
                               rtol=1e-5, atol=1e-6)
    assert int(m.num_batches_tracked) == 1


def _clips():
    """(B, T, N, h, w, 3) = (2, 4, 4, 32, 32, 3) seeded patches."""
    return np.random.RandomState(1).randn(2, 4, 4, 32, 32, 3).astype(
        np.float32)


def _jax_setup(model_type, fused, dtype=jnp.float32):
    """The JAX model, its seeded initial variables (numpy, with a nonzero
    head bias for ``scratch_zeropad``, which runs with one) and the clips."""
    head_bias = model_type == "scratch_zeropad"
    jm = JaxCRW(JaxConfig(model_type=model_type, temperature=0.05,
                          fused_walk=fused, dtype=dtype, head_bias=head_bias))
    x = _clips()
    variables = _np(dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 train=False)))
    if head_bias:
        rng = np.random.RandomState(5)
        variables["params"]["head"]["fc0"]["bias"] = (
            0.1 * rng.randn(128).astype(np.float32))
    return jm, variables, x, head_bias


def _jax_loss_fn(jm, variables, x):
    def f(params):
        (q, loss, diags), upd = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x, train=True, mutable=["batch_stats"])
        return loss, (q, diags, upd["batch_stats"])
    return f


def _torch_model(variables, **cfg):
    model = CRW(CRWConfig(temperature=0.05, **cfg))
    model.load_state_dict(state_from_flax(variables), strict=True)
    return model


def _assert_stats(model, stats_j, atol_of_scale):
    state = model.state_dict()
    for k, v in state_from_flax({"batch_stats": _np(stats_j)}).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(
                state[k].double().numpy(), v.double().numpy(), rtol=0,
                atol=atol_of_scale * max(1.0, float(v.abs().max())),
                err_msg=k)


def _assert_forward(q, loss, diags, model, out_j):
    loss_j, (q_j, diags_j, stats_j) = out_j
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(q_j), atol=1e-4)
    assert set(diags) == set(diags_j)
    for k, v in diags_j.items():
        np.testing.assert_allclose(float(diags[k].detach()), float(v),
                                   rtol=1e-4, atol=1e-5)
    _assert_stats(model, stats_j, 1e-4)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_crw_train_forward_matches_jax(fused):
    """``scratch`` (reflect padding), f32, B=2, T=4, N=4, 32 px, edge
    dropout off (its masks are drawn from a key inside the JAX model; given
    masks are held to JAX in tests/test_torch_walk*.py). 'on' runs the JAX
    Pallas walk in interpret mode and the port's fused plain version. q
    atol 1e-4, loss rtol 1e-4, new running statistics atol 1e-4 of their
    scale. (Gradients: ``test_crw_grads_match_jax_in_float64``.)"""
    jm, variables, x, head_bias = _jax_setup("scratch", fused)
    out_j = jax.jit(_jax_loss_fn(jm, variables, x))(variables["params"])
    model = _torch_model(variables, model_type="scratch", fused_walk=fused,
                         head_bias=head_bias)
    with torch.no_grad():
        q, loss, diags = model(torch.from_numpy(x), train=True)
    _assert_forward(q, loss, diags, model, out_j)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_crw_train_forward_and_grads_match_jax(fused):
    """``scratch_zeropad`` with a head bias: the forward as above, and every
    parameter's gradient against ``jax.grad``, mapped by
    ``state_from_flax``. Tolerance 1e-2 of each tensor's largest entry: at
    these random weights the f32 gradients are badly conditioned (sums that
    nearly cancel through train-mode BN, the walk at T 0.05), so two f32
    evaluations by different algorithms part by far more than f32
    rounding; with reflect padding they part further still. Gradients of
    both trunks are held tightly in f64 by
    ``test_crw_grads_match_jax_in_float64``."""
    jm, variables, x, head_bias = _jax_setup("scratch_zeropad", fused)
    out_j, grads_j = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jm, variables, x), has_aux=True))(variables["params"])
    model = _torch_model(variables, model_type="scratch_zeropad",
                         fused_walk=fused, head_bias=head_bias)
    q, loss, diags = model(torch.from_numpy(x), train=True)
    loss.backward()
    _assert_forward(q, loss, diags, model, out_j)
    grads = state_from_flax({"params": _np(grads_j)})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    assert "selfsim_fc.0.bias" in grads
    for k, g in grads.items():
        np.testing.assert_allclose(params[k].grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-2 * np.abs(g.numpy()).max(),
                                   err_msg=k)


@pytest.mark.parametrize("model_type", ["scratch", "scratch_zeropad"])
def test_crw_grads_match_jax_in_float64(model_type):
    """Every parameter's gradient of the train-mode loss, the port in f64
    against ``jax.grad`` under x64, for the reflect-padded flagship trunk
    (``scratch``: the reflect pad's backward) and the zeros-padded one.
    B=2, T=4, N=4 at 16 px (f64 convolutions are slow on the CPU; 16 px
    still reflect-pads every stage, layer4 at 2x2), walk off the fused
    path, the JAX model's f32 init cast to f64. Tolerance 3e-5 of each
    tensor's largest entry: both packages run the walk in f32 on the f64
    embeddings (the affinity einsum returns f32,
    ``preferred_element_type`` at ``videowalk_tpu/core/walk.py:72``), so
    the gradients keep f32 roundings of the affinities, summed in another
    order on each side and magnified by the walk at T 0.05; a fault in a
    gradient is of the order of its entries."""
    x = np.random.RandomState(1).randn(2, 4, 4, 16, 16, 3)
    cfg = dict(model_type=model_type, temperature=0.05, fused_walk="off")
    variables = _np(dict(JaxCRW(JaxConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32), train=False)))
    with jax.enable_x64(True):
        jm = JaxCRW(JaxConfig(dtype=jnp.float64, **cfg))
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        grads_j = _np(jax.jit(jax.grad(
            lambda p: _jax_loss_fn(jm, v64, jnp.asarray(x))(p)[0]))(
                v64["params"]))
    grads = state_from_flax({"params": grads_j})
    model = _torch_model(variables, dtype=torch.float64, **{
        k: v for k, v in cfg.items() if k != "temperature"}).double()
    q, loss, _ = model(torch.from_numpy(x), train=True)
    assert q.dtype == torch.float64
    loss.backward()
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for k, g in grads.items():          # f32 copies: 6e-8 of each entry
        g = g.double().numpy()
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=0,
                                   atol=3e-5 * np.abs(g).max(), err_msg=k)


def test_crw_train_forward_bf16_trunk_matches_jax():
    """The bench's compute type: bf16 convolutions, f32 BN statistics, f32
    head and walk. Both sides round activations to bf16 at other points,
    so: loss rtol 2e-2, q atol 3e-2 (unit vectors), running statistics
    atol 2e-2 of their scale."""
    jm, variables, x, _ = _jax_setup("scratch", "off", jnp.bfloat16)
    loss_j, (q_j, _, stats_j) = jax.jit(_jax_loss_fn(jm, variables, x))(
        variables["params"])
    model = _torch_model(variables, model_type="scratch", fused_walk="off",
                         dtype=torch.bfloat16)
    with torch.no_grad():
        q, loss, _ = model(torch.from_numpy(x), train=True)
    assert q.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=2e-2)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=3e-2)
    _assert_stats(model, stats_j, 2e-2)


@pytest.mark.parametrize("head_bias,head_depth",
                         [(False, 0), (True, 0), (True, 1), (False, -1)])
def test_state_from_flax_carries_the_full_model(head_bias, head_depth):
    """Every leaf of the full model (layer4 kept), heads with and without
    bias, loads with strict=True."""
    jm = JaxCRW(JaxConfig(model_type="scratch", head_depth=head_depth,
                          head_bias=head_bias))
    v = _np(dict(jm.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 2, 2, 32, 32, 3)), train=False)))
    state = state_from_flax(v)
    model = CRW(CRWConfig(model_type="scratch", head_depth=head_depth,
                          head_bias=head_bias))
    assert set(model.state_dict()) == set(state)
    assert "encoder.model.layer4.1.bn2.running_var" in state
    assert ("selfsim_fc.0.bias" in state) == (head_bias and head_depth >= 0)
    model.load_state_dict(state, strict=True)


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_optimizer_matches_optax(optim):
    """3 updates across a milestone at 2 (the third runs at lr * gamma),
    each fed the same JAX gradient: that of a quadratic at optax's current
    parameters. Compared update by update; rtol 1e-5, atol 1e-6 (a few f32
    ulps of parameters of order 1; an update is ~3e-2)."""
    rng = np.random.RandomState(2)
    p0 = {"w": rng.randn(5, 3).astype(np.float32),
          "b": rng.randn(3).astype(np.float32)}
    target = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
    grad_fn = jax.grad(lambda p: sum(jnp.sum((p[k] - target[k]) ** 2 * (i + 1))
                                     for i, k in enumerate(sorted(p))))
    kw = dict(lr=3e-2, milestones=(2,), gamma=0.3, optim=optim)
    tx = jax_make_optimizer(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt, sched = make_optimizer(**kw)([tp["b"], tp["w"]])
    for _ in range(3):
        g = grad_fn(jp)
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in tp:
            tp[k].grad = torch.from_numpy(np.array(g[k]))
        opt.step()
        sched.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-6)
    assert np.isclose(sched.get_last_lr()[0], 3e-2 * 0.3)


def test_train_step_updates_state_in_place():
    torch.manual_seed(0)
    model = CRW(CRWConfig(model_type="scratch", temperature=0.05,
                          edgedrop_rate=0.1, featdrop_rate=0.1,
                          remove_layers=("layer4",)))
    state = create_train_state(model, make_optimizer(lr=3e-4, milestones=(1,)),
                               device="cpu")
    step = make_train_step()
    x = torch.from_numpy(_clips())
    w0 = model.encoder.model.conv1.weight.detach().clone()
    rm0 = model.encoder.model.bn1.running_mean.clone()
    metrics = [step(state, x, torch.Generator().manual_seed(3))
               for _ in range(2)]
    assert state.step == 2
    assert all(torch.isfinite(m["loss"]) for m in metrics)
    assert set(metrics[0]) == {"loss", "xent cyc r1", "acc cyc r1",
                               "xent cyc r2", "acc cyc r2"}
    assert not torch.equal(model.encoder.model.conv1.weight, w0)
    assert not torch.equal(model.encoder.model.bn1.running_mean, rm0)
    assert int(model.encoder.model.bn1.num_batches_tracked) == 2
    assert np.isclose(state.scheduler.get_last_lr()[0], 3e-4 * 0.3)


def test_dropout_needs_a_generator_and_follows_it():
    torch.manual_seed(0)
    model = CRW(CRWConfig(model_type="scratch_zeropad", temperature=0.05,
                          edgedrop_rate=0.1, featdrop_rate=0.2,
                          remove_layers=("layer3", "layer4")))
    x = torch.from_numpy(_clips())
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(1))[1]
        b = model(x, generator=torch.Generator().manual_seed(1))[1]
        c = model(x, train=False)[1]
        with pytest.raises(ValueError, match="Generator"):
            model(x)
    assert float(a) == float(b) != float(c)
