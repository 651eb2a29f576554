"""The port's ResNet-50 (``Bottleneck``) against the JAX package's: the
trunk in eval mode, one identity block and one stride-2 projection block in
train mode, and a ``scratch50`` CRW training step.

Weights are seeded numpy arrays in the JAX variable tree's shapes (taken
from ``jax.eval_shape`` of the JAX init: a real ResNet-50 init takes ~15 s
on the CPU), carried to the port by ``state_from_flax``; the BN running
statistics, scales and biases are random, so the BN mapping is exercised."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig
from videowalk_tpu.models.resnet import Bottleneck as JaxBottleneck
from videowalk_tpu.models.resnet import resnet50 as jax_resnet50

from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.models.encoder import make_encoder
from videowalk_tpu_torch.models.resnet import Bottleneck, resnet50
from videowalk_tpu_torch.utils.checkpoint import state_from_flax

torch.set_num_threads(1)


def seeded_variables(shapes, rng, dtype=np.float32):
    """A flax ``{params, batch_stats}`` tree of ``shapes`` (``eval_shape``
    leaves) with seeded values: He-scaled kernels, BN scales near 1, small
    biases and means, variances in [0.5, 1.5]. The values are f32 numbers
    in ``dtype``, so ``state_from_flax`` (which writes f32) carries an f64
    tree exactly."""
    def fill(tree, name=None):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: fill(v, k) for k, v in tree.items()}
        shape = tuple(tree.shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:                                    # bias, mean
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32).astype(dtype)
    return {c: fill(shapes[c]) for c in ("params", "batch_stats")
            if c in shapes}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trunk_variables():
    """Seeded variables of the full JAX ResNet-50 trunk (layer4 kept): the
    same tree serves both paddings and, without its layer4, the trunk
    without layer4."""
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jax_resnet50("reflect").init(
        jax.random.PRNGKey(0), x, train=False))
    return seeded_variables(shapes, np.random.RandomState(0))


@pytest.mark.parametrize("padding", ["reflect", "zeros"])
@pytest.mark.parametrize("remove_layers", [(), ("layer4",)])
def test_resnet50_trunk_matches_jax_in_eval_mode(trunk_variables, padding,
                                                 remove_layers):
    """Eval-mode features of the two trunks, within 1e-5 of the features'
    largest entry (f32 convolutions by different algorithms through 16
    blocks); hid_dim and map_scale equal."""
    variables = {c: {k: v for k, v in tree.items()
                     if k.split("_")[0] not in remove_layers}
                 for c, tree in trunk_variables.items()}
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    net = jax_resnet50(padding, remove_layers)
    want = np.asarray(jax.jit(lambda v, xx: net.apply(v, xx, train=False))(
        variables, jnp.asarray(x)))
    model = resnet50(padding, remove_layers).eval()
    model.load_state_dict(state_from_flax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 4, 4, net.hid_dim)
    assert model.hid_dim == net.hid_dim == (1024 if remove_layers else 2048)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    model_type = "scratch50" if padding == "reflect" else "imagenet50"
    spec = make_encoder(model_type, remove_layers)
    assert spec.hid_dim == net.hid_dim and spec.map_scale == 8


@pytest.mark.parametrize("cin,planes,stride,hw", [(32, 8, 1, 8),
                                                  (16, 8, 2, 16)])
def test_bottleneck_train_mode_matches_jax_in_float64(cin, planes, stride,
                                                      hw):
    """One reflect-padded ``Bottleneck`` in train mode, f64 on both sides
    (JAX under x64): the output, the new running statistics (the batch
    moments at decay 0.9) and the gradients of every parameter and of the
    input against ``jax.grad``, within 1e-6 of each tensor's largest entry
    (``state_from_flax`` maps JAX's f64 results to the port's names as f32
    copies: 6e-8 of each entry). (32, 8, 1): the identity shortcut, its 8x8 3x3 routed with bn2's
    moments from the conv (the plain version on the CPU); (16, 8, 2): the
    stride-2 3x3 and the projection shortcut."""
    projection = stride != 1 or cin != 4 * planes
    jb = JaxBottleneck(filters=planes, stride=stride, padding_mode="reflect",
                       use_projection=projection, dtype=jnp.float64)
    rng = np.random.RandomState(2)
    x = rng.randn(3, hw, hw, cin)
    g = rng.randn(3, hw // stride, hw // stride, 4 * planes)
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda: jb.init(
            jax.random.PRNGKey(0), jnp.zeros(x.shape), train=False))
        variables = seeded_variables(shapes, rng, np.float64)

        def f(params, xx):
            y, upd = jb.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              xx, train=True, mutable=["batch_stats"])
            return jnp.sum(y * g), (y, upd["batch_stats"])

        (_, (y_j, stats_j)), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(variables["params"],
                                              jnp.asarray(x))
        y_j, stats_j, gp_j, gx_j = _np((y_j, stats_j, gp_j, gx_j))

    blk = Bottleneck(cin, planes, stride, "reflect", torch.float64).double()
    blk.load_state_dict({k: v.double() for k, v in state_from_flax(
        variables).items()}, strict=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).requires_grad_()
    y = blk(xt, train=True)
    (y * torch.from_numpy(g.transpose(0, 3, 1, 2))).sum().backward()

    def close(got, want, name):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)

    close(y.detach().numpy().transpose(0, 2, 3, 1), y_j, "y")
    close(xt.grad.numpy().transpose(0, 2, 3, 1), gx_j, "dx")
    state = blk.state_dict()
    for k, v in state_from_flax({"batch_stats": stats_j}).items():
        if not k.endswith("num_batches_tracked"):
            close(state[k].numpy(), v.double().numpy(), k)
    grads = state_from_flax({"params": gp_j})
    params = dict(blk.named_parameters())
    assert set(grads) == set(params)
    assert ("downsample.0.weight" in params) == projection
    for k, gk in grads.items():
        close(params[k].grad.numpy(), gk.double().numpy(), k)


def test_scratch50_crw_step_matches_jax_in_float64():
    """The ``scratch50`` CRW's train-mode loss and every parameter's
    gradient, layer3 and layer4 removed (C = 512 into the head), B=2, T=4,
    N=4 at 32 px (layer1's 8x8 3x3s routed), walk off the fused path, f64
    on both sides. Loss rtol 1e-9; gradients within 3e-5 of each tensor's
    largest entry, the f32 walk's bound in ``test_torch_train_step.py``
    (both packages take the affinities in f32)."""
    x = np.random.RandomState(1).randn(2, 4, 4, 32, 32, 3)
    cfg = dict(model_type="scratch50", temperature=0.05, fused_walk="off",
               remove_layers=("layer3", "layer4"))
    with jax.enable_x64(True):
        jm = JaxCRW(JaxConfig(dtype=jnp.float64, **cfg))
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 32, 32, 3)),
            train=False))
        variables = seeded_variables(shapes, np.random.RandomState(3),
                                     np.float64)

        def f(params):
            (_, loss, _), _ = jm.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(x), train=True, mutable=["batch_stats"])
            return loss

        loss_j, grads_j = _np(jax.jit(jax.value_and_grad(f))(
            variables["params"]))
    model = CRW(CRWConfig(dtype=torch.float64, **{
        k: v for k, v in cfg.items()})).double()
    model.load_state_dict({k: v.double() for k, v in state_from_flax(
        variables).items()}, strict=True)
    assert model.spec.hid_dim == 512
    _, loss, _ = model(torch.from_numpy(x), train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-9)
    grads = state_from_flax({"params": grads_j})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    assert "encoder.model.layer2.3.conv3.weight" in params
    for k, g in grads.items():
        g = g.double().numpy()
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=0,
                                   atol=3e-5 * np.abs(g).max(), err_msg=k)
