"""The reflect-conv slice against the JAX package on the CPU: the port's
``reflect_conv3x3`` / ``reflect_conv3x3_stats`` (``ops/rconv.py``, plain
versions on the CPU) against the JAX ``ops/rconv_kernel.py`` ops (Pallas
in interpret mode), the route gate against ``rconv_kernel_routes``, and the
route-on, ``bn_fuse="stats"`` BasicBlocks and trunk against the JAX model
under ``VIDEOWALK_RCONV=on VIDEOWALK_BN_FUSE=stats``.

Layouts: JAX is NHWC/HWIO, the port NCHW/OIHW; inputs are made with numpy
from a seed and transposed on the way in and out. Each tolerance is stated
at its test with its reason."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu.ops import rconv_kernel as jrk
from videowalk_tpu.ops import reflect_conv as jrc

from videowalk_tpu_torch.ops import rconv as rc
from videowalk_tpu_torch.ops.reflect_conv import rconv_kernel_routes
from videowalk_tpu_torch.utils.checkpoint import state_from_flax

torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("N,H,W,cin,cout", [
    (2, 16, 16, 8, 8), (4, 8, 8, 8, 16), (2, 32, 32, 4, 8)])
def test_reflect_conv3x3_matches_jax(N, H, W, cin, cout):
    """Forward, dx and dW through the autograd Function. f32, tolerance
    1e-5 (y) and 1e-4 (gradients) of each output's largest entry: the same
    f32 products summed in another order (JAX's rolls and leg folds vs
    ``F.pad`` + conv and its autograd)."""
    x, w = _rand((N, H, W, cin), 1), _rand((3, 3, cin, cout), 2, 0.1)
    gy = _rand((N, H, W, cout), 3)
    y_j, vjp = jax.vjp(jrk.reflect_conv3x3, jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(gy))

    xt = _nchw(x).requires_grad_()
    wt = _oihw(w).requires_grad_()
    y = rc.reflect_conv3x3(xt, wt)
    y.backward(_nchw(gy))
    _close(_nhwc(y), y_j, 1e-5, "y")
    _close(_nhwc(xt.grad), dx_j, 1e-4, "dx")
    _close(wt.grad.numpy().transpose(2, 3, 1, 0), dw_j, 1e-4, "dw")


def test_reflect_conv3x3_stats_matches_jax():
    """N=5 (not a multiple of the JAX kernel's image block), a loss that
    touches y, s1 and s2. f32; y 1e-5 of its largest entry, moments 1e-5
    of Σ|y| (the same values summed in another order), gradients 1e-4 of
    their largest entry (the moment cotangents folded into gy)."""
    N, H, W, cin, cout = 5, 8, 8, 8, 16
    x, w = _rand((N, H, W, cin), 12), _rand((3, 3, cin, cout), 13, 0.1)
    gy, c1, c2 = (_rand((N, H, W, cout), 14), _rand((cout,), 15),
                  _rand((cout,), 16))

    def loss_j(x, w):
        y, s1, s2 = jrk.reflect_conv3x3_stats(x, w)
        return jnp.sum(y * gy) + jnp.sum(s1 * c1) + jnp.sum(s2 * c2), (
            y, s1, s2)

    (_, (y_j, s1_j, s2_j)), (dx_j, dw_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))

    xt = _nchw(x).requires_grad_()
    wt = _oihw(w).requires_grad_()
    y, s1, s2 = rc.reflect_conv3x3_stats(xt, wt)
    assert s1.dtype == s2.dtype == torch.float32
    ((y * _nchw(gy)).sum() + (s1 * torch.from_numpy(c1)).sum()
     + (s2 * torch.from_numpy(c2)).sum()).backward()
    _close(_nhwc(y), y_j, 1e-5, "y")
    mass = float(np.abs(np.asarray(y_j)).sum())
    np.testing.assert_allclose(s1.detach().numpy(), s1_j, rtol=0,
                               atol=1e-5 * mass)
    np.testing.assert_allclose(s2.detach().numpy(), s2_j, rtol=0,
                               atol=1e-5 * float(np.sum(np.asarray(y_j) ** 2)))
    _close(_nhwc(xt.grad), dx_j, 1e-4, "dx")
    _close(wt.grad.numpy().transpose(2, 3, 1, 0), dw_j, 1e-4, "dw")


def test_reflect_conv3x3_bf16_forward_matches_jax():
    """bf16 operands, f32 accumulation, bf16 output on both sides:
    tolerance 1e-2 of the largest entry (each side rounds its f32 sums to
    bf16 once, ~4e-3). The moments are f32 sums of each side's own cast y,
    held per channel: s1 within 1e-5 of that channel's Σ|y| and s2 within
    1e-5 of its Σy² (the same values summed in another order), plus what
    the two cast y differ by in that channel (nothing at this shape)."""
    x, w = _rand((2, 8, 8, 16), 4), _rand((3, 3, 16, 32), 5, 0.1)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    y_j, s1_j, s2_j = jrk.reflect_conv3x3_stats(xb, wb)
    assert y_j.dtype == jnp.bfloat16
    xt, wt = _nchw(x).bfloat16(), _oihw(w).bfloat16()
    y = rc.reflect_conv3x3(xt, wt)
    ys, s1, s2 = rc.reflect_conv3x3_stats(xt, wt)
    assert y.dtype == ys.dtype == torch.bfloat16
    assert torch.equal(y, ys)
    _close(_nhwc(y), np.asarray(y_j, np.float32), 1e-2, "y")
    yp, yj = _nhwc(ys), np.asarray(y_j, np.float32)
    axes = (0, 1, 2)
    lim1 = 1e-5 * np.abs(yj).sum(axes) + np.abs(yp - yj).sum(axes)
    lim2 = 1e-5 * (yj ** 2).sum(axes) + np.abs(yp ** 2 - yj ** 2).sum(axes)
    assert np.all(np.abs(s1.numpy() - np.asarray(s1_j)) <= lim1)
    assert np.all(np.abs(s2.numpy() - np.asarray(s2_j)) <= lim2)


def _jax_routes(monkeypatch, H, W, C, F, k=3, s=1, p=1, **env):
    for var in ("VIDEOWALK_RCONV", "VIDEOWALK_RCONV_MIN_C",
                "VIDEOWALK_RCONV_ALLOW16", "VIDEOWALK_RCONV_ALLOW32"):
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    return jrc.rconv_kernel_routes(H, W, C, F, k, s, p)


_GRID = [(H, W, C, F, k, s, p)
         for H in (4, 8, 12, 16, 32, 64) for W in (8, 16, 32)
         for C, F in ((64, 64), (256, 512), (512, 512), (256, 256))
         for k, s, p in ((3, 1, 1), (3, 2, 1), (7, 2, 3), (1, 1, 0))]


def test_routes_match_jax(monkeypatch):
    """``on``, ``off`` and ``auto`` over a grid of geometries, the JAX
    package's shape knobs at their defaults (its backend pinned to 'tpu':
    the port's gate has no backend term)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    n_true = 0
    for H, W, C, F, k, s, p in _GRID:
        for mode in ("on", "off", "auto"):
            want = _jax_routes(monkeypatch, H, W, C, F, k, s, p,
                               VIDEOWALK_RCONV=mode)
            assert rconv_kernel_routes(H, W, C, F, mode, kernel=k, stride=s,
                                       pad=p) == want
            n_true += want and mode == "auto"
    assert n_true > 0
    with pytest.raises(ValueError, match="auto | on | off"):
        rconv_kernel_routes(8, 8, 512, 512, "maybe")


def test_default_route_is_the_layer4_interiors():
    """The port's default (``auto``) on the flagship's 64 px patches: the
    three 8x8 512->512 convs of layer4, and nothing at 16x16 or below 512
    channels."""
    assert rconv_kernel_routes(8, 8, 512, 512)
    assert not rconv_kernel_routes(8, 8, 256, 512)     # layer4.0.conv1
    assert not rconv_kernel_routes(8, 8, 256, 256)     # layer3
    assert not rconv_kernel_routes(16, 16, 64, 64)     # layer1
    assert rconv_kernel_routes(16, 16, 64, 64, "on")
    assert rconv_kernel_routes(8, 8, 128, 256, "on")
    assert not rconv_kernel_routes(16, 16, 64, 128, "on", stride=2)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(rc, name)

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(rc, name, spy)
    return calls


def test_basic_blocks_route_on_stats_match_jax(monkeypatch):
    """Two stacked reflect BasicBlocks (16 channels, 8x8) in train mode,
    the port with ``rconv="on", bn_fuse="stats"`` against the JAX blocks
    under ``VIDEOWALK_RCONV=on VIDEOWALK_BN_FUSE=stats`` (Pallas kernels
    in interpret mode, ``FusedStatsBN``): loss, updated running statistics
    and every parameter gradient. No stem or maxpool (their argmax ties
    make gradients discontinuous, see tests/test_rconv_kernel.py). f32;
    loss rtol 1e-5, statistics rtol 1e-4 + atol 1e-5, gradients 1e-3 of
    each tensor's largest entry (f32 moments summed in another order, then
    scaled by 1/std through two train-mode BNs)."""
    import flax.linen as fnn

    from videowalk_tpu.models.resnet import BasicBlock as JaxBlock

    from videowalk_tpu_torch.models.resnet import BasicBlock

    class TwoBlocks(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool):
            x = JaxBlock(filters=16, padding_mode="reflect", name="b0")(
                x, train)
            return JaxBlock(filters=16, padding_mode="reflect", name="b1")(
                x, train)

    monkeypatch.setenv("VIDEOWALK_RCONV", "on")
    monkeypatch.setenv("VIDEOWALK_BN_FUSE", "stats")
    net = TwoBlocks()
    x = _rand((4, 8, 8, 16), 21, 0.5)
    ct = _rand((4, 8, 8, 16), 22)
    variables = jax.tree_util.tree_map(np.asarray, dict(
        net.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)))

    def loss_j(params):
        y, upd = net.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(y * ct), upd["batch_stats"]

    (l_j, stats_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        variables["params"])

    model = torch.nn.Module()
    model.b0 = BasicBlock(16, 16, 1, "reflect", rconv="on", bn_fuse="stats")
    model.b1 = BasicBlock(16, 16, 1, "reflect", rconv="on", bn_fuse="stats")
    model.load_state_dict(state_from_flax(variables), strict=True)
    fwd = _spy(monkeypatch, "reflect_conv_fwd_stats")
    dxs = _spy(monkeypatch, "reflect_conv_dx")
    dws = _spy(monkeypatch, "reflect_conv_dw")
    y = model.b1(model.b0(_nchw(x), train=True), train=True)
    loss = (y * _nchw(ct)).sum()
    loss.backward()
    assert (len(fwd), len(dxs), len(dws)) == (4, 3, 4)   # x needs no grad
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-5)
    state = model.state_dict()
    for k, v in state_from_flax({"batch_stats": jax.tree_util.tree_map(
            np.asarray, stats_j)}).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    grads = state_from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                              grads_j)})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for k, g in grads.items():
        _close(params[k].grad.numpy(), g.numpy(), 1e-3, k)


def test_resnet_route_on_stats_forward_and_stats_match_jax(monkeypatch):
    """The reflect ResNet-18 trunk (layer3/4 removed, 32 px: layer1 at 8x8
    routes) in train mode, port ``rconv="on", bn_fuse="stats"`` against
    JAX under ``VIDEOWALK_RCONV=on VIDEOWALK_BN_FUSE=stats``: output and
    updated running statistics (as the JAX package's own
    ``test_resnet_bn_fusion_forward_and_stats_match``: output rtol 1e-3 +
    atol 5e-5, two stacked BNs rescale f32 reassociation noise by 1/std;
    statistics rtol 1e-4 + atol 1e-5)."""
    from videowalk_tpu.models.resnet import resnet18 as jax_resnet18

    from videowalk_tpu_torch.models.resnet import resnet18

    monkeypatch.setenv("VIDEOWALK_RCONV", "on")
    monkeypatch.setenv("VIDEOWALK_BN_FUSE", "stats")
    net = jax_resnet18(padding_mode="reflect",
                       remove_layers=("layer3", "layer4"))
    x = _rand((2, 32, 32, 3), 21)
    variables = jax.tree_util.tree_map(np.asarray, dict(
        net.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)))
    y_j, upd = net.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])

    model = resnet18("reflect", ("layer3", "layer4"), rconv="on",
                     bn_fuse="stats")
    model.load_state_dict(state_from_flax(variables), strict=True)
    fwd = _spy(monkeypatch, "reflect_conv_fwd_stats")
    with torch.no_grad():
        y = model(_nchw(x), train=True)
    assert len(fwd) == 4                                  # layer1 at 8x8
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), rtol=1e-3,
                               atol=5e-5)
    state = model.state_dict()
    for k, v in state_from_flax({"batch_stats": jax.tree_util.tree_map(
            np.asarray, upd["batch_stats"])}).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_state_from_flax_loads_a_route_on_model(monkeypatch):
    """A JAX CRW built and run with the reflect-conv route on carries its
    weights into the port's route-on CRW with ``strict=True``, and the
    eval-mode features agree (the port's routed convs take #4's plain
    version in eval mode; atol 1e-4 as in tests/test_torch_encoder.py)."""
    from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig

    from videowalk_tpu_torch.models import CRW, CRWConfig

    monkeypatch.setenv("VIDEOWALK_RCONV", "on")
    x = np.random.RandomState(0).rand(1, 1, 64, 64, 3).astype(np.float32)
    jm = JaxCRW(JaxConfig(model_type="scratch", remove_layers=("layer4",)))
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        just_feats=True, train=False)
    q_j, maps_j = jm.apply(variables, jnp.asarray(x), just_feats=True,
                           train=False)
    model = CRW(CRWConfig(model_type="scratch", remove_layers=("layer4",),
                          rconv="on")).eval()
    model.load_state_dict(state_from_flax(jax.tree_util.tree_map(
        np.asarray, dict(variables))), strict=True)
    fwd = _spy(monkeypatch, "reflect_conv_fwd")
    with torch.no_grad():
        q, maps = model(torch.from_numpy(x), just_feats=True, train=False)
    assert len(fwd) == 11        # layer1 (16x16) + layer2-3 interiors (8x8)
    np.testing.assert_allclose(maps.numpy(), np.asarray(maps_j), atol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=1e-4)


def test_config_validation():
    from videowalk_tpu_torch.models import CRW, CRWConfig

    with pytest.raises(NotImplementedError, match="slice 4"):
        CRW(CRWConfig(bn_fuse="auto"))
    with pytest.raises(ValueError, match="bn_fuse"):
        CRW(CRWConfig(bn_fuse="maybe"))
    with pytest.raises(ValueError, match="rconv"):
        CRW(CRWConfig(rconv="maybe"))
    cfg = CRWConfig()
    assert (cfg.rconv, cfg.bn_fuse) == ("auto", "stats")
