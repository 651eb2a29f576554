"""The reflect-conv slice against the JAX package on the CPU: the port's
``reflect_conv3x3`` / ``reflect_conv3x3_stats`` /
``reflect_conv3x3_bnin_stats`` (``ops/rconv.py``, plain versions on the
CPU) against the JAX ``ops/rconv_kernel.py`` ops (Pallas in interpret
mode), the route gate against ``rconv_kernel_routes``, and the route-on
BasicBlocks and trunk with ``bn_fuse="stats"`` and ``"auto"`` (the BN-input
chain) against the JAX model under ``VIDEOWALK_RCONV=on`` and the same
``VIDEOWALK_BN_FUSE``.

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
    """``on`` and ``off`` over a grid of geometries equal the JAX package's
    (its shape knobs at their defaults, its backend pinned to 'tpu': the
    port's gate has no backend term); ``auto`` is the port's own H100 set,
    every shape ``rconv_supported`` takes, so ``auto`` is within ``on``
    and routes shapes JAX's TPU ``auto`` leaves out."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    n_true = n_past_tpu = 0
    for H, W, C, F, k, s, p in _GRID:
        for mode in ("on", "off"):
            want = _jax_routes(monkeypatch, H, W, C, F, k, s, p,
                               VIDEOWALK_RCONV=mode)
            assert rconv_kernel_routes(H, W, C, F, mode, kernel=k, stride=s,
                                       pad=p) == want
        auto = rconv_kernel_routes(H, W, C, F, "auto", kernel=k, stride=s,
                                   pad=p)
        assert auto == rc.rconv_supported(H, W, k, s, p)
        assert not auto or rconv_kernel_routes(H, W, C, F, "on", kernel=k,
                                               stride=s, pad=p)
        n_true += auto
        n_past_tpu += auto and not _jax_routes(
            monkeypatch, H, W, C, F, k, s, p, VIDEOWALK_RCONV="auto")
    assert n_true > 0 and n_past_tpu > 0
    with pytest.raises(ValueError, match="auto | on | off"):
        rconv_kernel_routes(8, 8, 512, 512, "maybe")


def test_default_route_is_every_supported_conv():
    """The port's default (``auto``) on the flagship's 64 px patches: every
    3x3 stride-1 reflect conv of the blocks, layer1's 16x16 maps and the
    8x8 maps of layer2-4 at every width, and nothing strided, past 32x32 or
    off the powers of two."""
    assert rconv_kernel_routes(8, 8, 512, 512)
    assert rconv_kernel_routes(8, 8, 256, 512)         # layer4.0.conv1
    assert rconv_kernel_routes(8, 8, 256, 256)         # layer3
    assert rconv_kernel_routes(16, 16, 64, 64)         # layer1
    assert rconv_kernel_routes(32, 32, 128, 128)       # 256 px frames' layer2
    assert not rconv_kernel_routes(16, 16, 64, 128, stride=2)
    assert not rconv_kernel_routes(64, 64, 64, 64)     # 256 px frames' layer1
    assert not rconv_kernel_routes(60, 107, 256, 256)  # DAVIS-480p eval
    assert not rconv_kernel_routes(8, 8, 512, 512, "off")


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

    with pytest.raises(ValueError, match="bn_fuse"):
        CRW(CRWConfig(bn_fuse="maybe"))
    with pytest.raises(ValueError, match="rconv"):
        CRW(CRWConfig(rconv="maybe"))
    cfg = CRWConfig()
    assert (cfg.rconv, cfg.bn_fuse) == ("auto", "auto")
    trunk = CRW(cfg).encoder.model
    assert {b.bn_fuse for b in trunk.layer4} == {"auto"}


# ------------------------------------------------- the BN-input chain


def _bnin_inputs(N, H, W, cin, cout, seed):
    """x, a > 0, b of both signs (a real share of relu(a*x+b) is zero), w,
    and cotangents for y, s1, s2."""
    return dict(x=_rand((N, H, W, cin), seed),
                a=np.abs(_rand((cin,), seed + 1)) + 0.5,
                b=_rand((cin,), seed + 2, 0.3),
                w=_rand((3, 3, cin, cout), seed + 3, 0.1),
                gy=_rand((N, H, W, cout), seed + 4),
                c1=_rand((cout,), seed + 5), c2=_rand((cout,), seed + 6))


def _bnin_torch(d, dtype=torch.float32):
    """The port's op and its gradients through a loss on y, s1 and s2."""
    x = _nchw(d["x"]).to(dtype).requires_grad_()
    a = torch.from_numpy(d["a"]).requires_grad_()
    b = torch.from_numpy(d["b"]).requires_grad_()
    w = _oihw(d["w"]).to(dtype).requires_grad_()
    y, s1, s2 = rc.reflect_conv3x3_bnin_stats(x, a, b, w)
    ((y.float() * _nchw(d["gy"])).sum() + (s1 * torch.from_numpy(d["c1"])).sum()
     + (s2 * torch.from_numpy(d["c2"])).sum()).backward()
    return (y, s1, s2), (x.grad, a.grad, b.grad, w.grad)


@pytest.mark.parametrize("N,H,W,cin,cout", [
    (5, 8, 8, 8, 16), (2, 16, 16, 8, 8), (1, 32, 8, 16, 8)])
def test_reflect_conv3x3_bnin_stats_matches_jax(N, H, W, cin, cout):
    """y, s1, s2 and the gradients for x, a, b and w through a loss on all
    three outputs, against the JAX op (Pallas in interpret mode; N=5 is not
    a multiple of its image block). f32, rtol 1e-4 + atol 1e-4 as the JAX
    package's own oracle test: the same f32 products summed in another
    order. No pre-activation of these seeds lies within a rounding of 0,
    so the ReLU gates agree."""
    d = _bnin_inputs(N, H, W, cin, cout, 30)

    def loss_j(x, a, b, w):
        y, s1, s2 = jrk.reflect_conv3x3_bnin_stats(x, a, b, w)
        return (jnp.sum(y * d["gy"]) + jnp.sum(s1 * d["c1"])
                + jnp.sum(s2 * d["c2"])), (y, s1, s2)

    (_, (y_j, s1_j, s2_j)), g_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(d[k]) for k in "xabw"))
    (y, s1, s2), (dx, da, db, dw) = _bnin_torch(d)
    assert s1.dtype == s2.dtype == da.dtype == db.dtype == torch.float32
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_nhwc(y), y_j, **tol)
    np.testing.assert_allclose(s1.detach().numpy(), s1_j, **tol)
    np.testing.assert_allclose(s2.detach().numpy(), s2_j, **tol)
    np.testing.assert_allclose(_nhwc(dx), g_j[0], err_msg="dx", **tol)
    np.testing.assert_allclose(da.numpy(), g_j[1], err_msg="da", **tol)
    np.testing.assert_allclose(db.numpy(), g_j[2], err_msg="db", **tol)
    np.testing.assert_allclose(dw.numpy().transpose(2, 3, 1, 0), g_j[3],
                               err_msg="dw", rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("N,H,W,cin,cout", [
    (4, 8, 8, 8, 16), (2, 16, 8, 16, 8)])
def test_bnin_plain_backward_matches_autograd(N, H, W, cin, cout):
    """The hand VJP's pieces as the wrappers compute them on the CPU
    (``dx = dxn*g*a``, ``da``, ``db``, dW of the rebuilt ``xn``) at a given
    ``gy`` against autograd of ``conv(relu(a*x + b))``. f32, 1e-5 of each
    output's largest entry (f32 sums in another order)."""
    d = _bnin_inputs(N, H, W, cin, cout, 70)
    x, w, gy = _nchw(d["x"]), _oihw(d["w"]), _nchw(d["gy"])
    a, b = torch.from_numpy(d["a"]), torch.from_numpy(d["b"])
    leaves = [t.clone().requires_grad_() for t in (x, a, b, w)]
    xx, aa, bb, ww = leaves
    y = rc.reflect_conv_plain(
        torch.relu(xx * aa[None, :, None, None] + bb[None, :, None, None]), ww)
    want = torch.autograd.grad(y, leaves, gy)
    dx, da, db = rc.reflect_conv_dx_bnin(gy, w, x, a, b)
    dw = rc.reflect_conv_dw_bnin(x, a, b, gy, w)
    for name, got, ref in zip(("dx", "da", "db", "dw"), (dx, da, db, dw),
                              (want[0], want[1], want[2], want[3])):
        _close(got.numpy(), ref.numpy(), 1e-5, name)


def test_reflect_conv3x3_bnin_stats_bf16_matches_jax():
    """bf16 x and w, f32 a and b, on both sides: xn is rounded to bf16
    before the product and y after it, so y is held to 1e-2 of its largest
    entry (one bf16 rounding of an f32 sum each side, ~4e-3, and an xn
    entry rounded the other way where ``x*a + b`` was fused on one side).
    Moments are f32 sums of each side's own cast y, per channel: s1 within
    1e-5 of that channel's sum |y| and s2 within 1e-5 of its sum y^2, plus
    what the two cast y differ by in that channel."""
    d = _bnin_inputs(2, 8, 8, 16, 32, 40)
    y_j, s1_j, s2_j = jrk.reflect_conv3x3_bnin_stats(
        jnp.asarray(d["x"], jnp.bfloat16), jnp.asarray(d["a"]),
        jnp.asarray(d["b"]), jnp.asarray(d["w"], jnp.bfloat16))
    assert y_j.dtype == jnp.bfloat16
    (y, s1, s2), (dx, da, db, dw) = _bnin_torch(d, torch.bfloat16)
    assert y.dtype == dx.dtype == dw.dtype == torch.bfloat16
    assert s1.dtype == s2.dtype == da.dtype == db.dtype == torch.float32
    yp, yj = _nhwc(y), np.asarray(y_j, np.float32)
    _close(yp, yj, 1e-2, "y")
    axes = (0, 1, 2)
    lim1 = 1e-5 * np.abs(yj).sum(axes) + np.abs(yp - yj).sum(axes)
    lim2 = 1e-5 * (yj ** 2).sum(axes) + np.abs(yp ** 2 - yj ** 2).sum(axes)
    assert np.all(np.abs(s1.detach().numpy() - np.asarray(s1_j)) <= lim1)
    assert np.all(np.abs(s2.detach().numpy() - np.asarray(s2_j)) <= lim2)
    assert all(torch.isfinite(t.float()).all() for t in (dx, da, db, dw))


@pytest.mark.parametrize("N,H,W,cin,cout", [(2, 8, 8, 16, 32),
                                            (1, 32, 8, 16, 8)])
def test_bnin_bf16_plain_backward_matches_jax(N, H, W, cin, cout):
    """The chain's bf16 backward as the card holds its kernels #7 and #8
    (the wrappers on CPU tensors: the plain versions) against ``jax.vjp``
    of the JAX op in bf16 (Pallas in interpret mode) at the same gy, with
    zero moment cotangents. dx within 2e-2 and dW within 1e-2 of the
    largest entry: both sides sum dxn (and dW) in f32 in another order and
    round once to bf16 (one bf16 ulp, ~4e-3). da and db per channel within
    2e-4 of that channel's Σ|dxn·g·x| and Σ|dxn·g| (``DAB_TOL`` of
    ``chip_smoke.py``): both sum the same f32 products in another order."""
    d = _bnin_inputs(N, H, W, cin, cout, 80)
    bf = jnp.bfloat16
    (_, s1_j, s2_j), vjp = jax.vjp(
        jrk.reflect_conv3x3_bnin_stats, jnp.asarray(d["x"], bf),
        jnp.asarray(d["a"]), jnp.asarray(d["b"]), jnp.asarray(d["w"], bf))
    dx_j, da_j, db_j, dw_j = vjp((jnp.asarray(d["gy"], bf),
                                  jnp.zeros_like(s1_j), jnp.zeros_like(s2_j)))

    x, w = _nchw(d["x"]).bfloat16(), _oihw(d["w"]).bfloat16()
    gy = _nchw(d["gy"]).bfloat16()
    a, b = torch.from_numpy(d["a"]), torch.from_numpy(d["b"])
    dx, da, db = rc.reflect_conv_dx_bnin(gy, w, x, a, b)
    dw = rc.reflect_conv_dw_bnin(x, a, b, gy, w)
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert da.dtype == db.dtype == torch.float32
    _close(_nhwc(dx), np.asarray(dx_j, np.float32), 2e-2, "dx")
    _close(dw.float().numpy().transpose(2, 3, 1, 0),
           np.asarray(dw_j, np.float32), 1e-2, "dw")
    dxg = (rc.reflect_conv_plain_bwd(x.float(), w.float(), gy.float())[0]
           * rc.bnin_plain(x, a, b)[1])
    mass_a = (dxg * x.float()).abs().sum((0, 2, 3)).numpy()
    mass_b = dxg.abs().sum((0, 2, 3)).numpy()
    assert np.all(np.abs(da.numpy() - np.asarray(da_j)) <= 2e-4 * mass_a)
    assert np.all(np.abs(db.numpy() - np.asarray(db_j)) <= 2e-4 * mass_b)


def _jax_blocks(monkeypatch, bn_fuse, specs, x, ct):
    """Stacked JAX BasicBlocks ``specs = [(filters, stride, projection)]``
    under ``VIDEOWALK_RCONV=on VIDEOWALK_BN_FUSE=bn_fuse`` in train mode:
    the variables, the loss ``sum(y * ct)``, the updated statistics and the
    parameter gradients."""
    import flax.linen as fnn

    from videowalk_tpu.models.resnet import BasicBlock as JaxBlock

    class Blocks(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool):
            for i, (filters, stride, proj) in enumerate(specs):
                x = JaxBlock(filters=filters, stride=stride,
                             padding_mode="reflect", use_projection=proj,
                             name=f"b{i}")(x, train)
            return x

    monkeypatch.setenv("VIDEOWALK_RCONV", "on")
    monkeypatch.setenv("VIDEOWALK_BN_FUSE", bn_fuse)
    net = Blocks()
    variables = jax.tree_util.tree_map(np.asarray, dict(
        net.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)))

    def loss_j(params):
        y, upd = net.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(y * ct), upd["batch_stats"]

    (l_j, stats_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        variables["params"])
    return variables, float(l_j), stats_j, grads_j


def _torch_blocks(specs, cin, variables, **kw):
    from videowalk_tpu_torch.models.resnet import BasicBlock

    model = torch.nn.Module()
    for i, (filters, stride, _) in enumerate(specs):
        setattr(model, f"b{i}", BasicBlock(cin, filters, stride, "reflect",
                                           **kw))
        cin = filters
    model.load_state_dict(state_from_flax(variables), strict=True)
    return model


def _run_blocks(model, x, ct, train=True):
    y = _nchw(x)
    for block in model.children():
        y = block(y, train=train)
    loss = (y * _nchw(ct)).sum()
    loss.backward()
    return y, loss


_WRAPPERS = ("reflect_conv_fwd", "reflect_conv_fwd_stats",
             "reflect_conv_fwd_bnin_stats", "reflect_conv_dx",
             "reflect_conv_dx_bnin", "reflect_conv_dw", "reflect_conv_dw_bnin")


def _spy_all(monkeypatch):
    return {name: _spy(monkeypatch, name) for name in _WRAPPERS}


def _counts(spies):
    return {k: len(v) for k, v in spies.items() if v}


def _assert_blocks_match(model, loss, l_j, stats_j, grads_j):
    """loss rtol 1e-5, statistics rtol 1e-4 + atol 1e-5, gradients 1e-3 of
    each tensor's largest entry (f32 moments summed in another order, then
    scaled by 1/std through the train-mode BNs): the tolerances of
    ``test_basic_blocks_route_on_stats_match_jax``."""
    np.testing.assert_allclose(float(loss.detach()), l_j, rtol=1e-5)
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


def test_basic_blocks_route_on_auto_match_jax(monkeypatch):
    """Two stacked reflect BasicBlocks (16 channels, 8x8) in train mode,
    the port with ``rconv="on", bn_fuse="auto"`` against the JAX blocks
    under ``VIDEOWALK_RCONV=on VIDEOWALK_BN_FUSE=auto``: both take the
    chain conv1 (#5) -> ``BNAffine`` -> conv2 of ``relu(a*y1 + b)`` (#6) ->
    ``FusedStatsBN``; backward #7 and #8 at each conv2, #9/#10 at conv1.
    Loss, running statistics and every parameter gradient."""
    specs = [(16, 1, False), (16, 1, False)]
    x, ct = _rand((4, 8, 8, 16), 21, 0.5), _rand((4, 8, 8, 16), 22)
    variables, l_j, stats_j, grads_j = _jax_blocks(monkeypatch, "auto",
                                                   specs, x, ct)
    model = _torch_blocks(specs, 16, variables, rconv="on", bn_fuse="auto")
    spies = _spy_all(monkeypatch)
    _, loss = _run_blocks(model, x, ct)
    assert _counts(spies) == dict(
        reflect_conv_fwd_stats=2, reflect_conv_fwd_bnin_stats=2,
        reflect_conv_dx_bnin=2, reflect_conv_dw_bnin=2,
        reflect_conv_dx=1, reflect_conv_dw=2)            # x needs no grad
    _assert_blocks_match(model, loss, l_j, stats_j, grads_j)


def test_basic_block_chain_with_unrouted_conv1_matches_jax(monkeypatch):
    """A stride-2 projection block (8 -> 16 channels, 16x16 -> 8x8) under
    ``on`` + ``auto``: conv1 is stride 2 and does not route, so ``bn1``'s
    affine reduces its own moments (``BNAffine`` with ``moments=None``),
    and conv2 still takes the chain."""
    specs = [(16, 2, True)]
    x, ct = _rand((4, 16, 16, 8), 23, 0.5), _rand((4, 8, 8, 16), 24)
    variables, l_j, stats_j, grads_j = _jax_blocks(monkeypatch, "auto",
                                                   specs, x, ct)
    model = _torch_blocks(specs, 8, variables, rconv="on", bn_fuse="auto")
    spies = _spy_all(monkeypatch)
    _, loss = _run_blocks(model, x, ct)
    assert _counts(spies) == dict(reflect_conv_fwd_bnin_stats=1,
                                  reflect_conv_dx_bnin=1,
                                  reflect_conv_dw_bnin=1)
    _assert_blocks_match(model, loss, l_j, stats_j, grads_j)


@pytest.mark.parametrize("rconv", ["on", "off"])
def test_bn_fuse_modes_agree_inside_the_port(monkeypatch, rconv):
    """``auto``, ``stats`` and ``off`` on the same weights and input
    compute the same function (with ``rconv="off"`` nothing routes and the
    three are one path): loss rtol 1e-5, statistics rtol 1e-4 + atol 1e-5,
    gradients 1e-3 of each tensor's largest entry, as against JAX."""
    specs = [(16, 2, True), (16, 1, False)]
    x, ct = _rand((4, 16, 16, 8), 25, 0.5), _rand((4, 8, 8, 16), 26)
    variables = _jax_blocks(monkeypatch, "off", specs, x, ct)[0]
    out = {}
    for mode in ("auto", "stats", "off"):
        model = _torch_blocks(specs, 8, variables, rconv=rconv, bn_fuse=mode)
        _, loss = _run_blocks(model, x, ct)
        out[mode] = (float(loss.detach()), model.state_dict(),
                     {k: p.grad for k, p in model.named_parameters()})
    for mode in ("auto", "stats"):
        np.testing.assert_allclose(out[mode][0], out["off"][0], rtol=1e-5)
        for k, v in out["off"][1].items():
            np.testing.assert_allclose(out[mode][1][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        for k, g in out["off"][2].items():
            _close(out[mode][2][k].numpy(), g.numpy(), 1e-3, f"{mode} {k}")


def test_eval_mode_block_takes_no_chain(monkeypatch):
    """Eval mode under ``on`` + ``auto``: both convs go through the plain
    forward (#4), BN normalizes with the running statistics (untouched),
    and the output equals the ``bn_fuse="off"`` block's exactly."""
    specs = [(16, 1, False)]
    x, ct = _rand((2, 8, 8, 16), 27, 0.5), _rand((2, 8, 8, 16), 28)
    variables = _jax_blocks(monkeypatch, "off", specs, x, ct)[0]
    model = _torch_blocks(specs, 16, variables, rconv="on", bn_fuse="auto")
    ref = _torch_blocks(specs, 16, variables, rconv="on", bn_fuse="off")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    spies = _spy_all(monkeypatch)
    y, _ = _run_blocks(model, x, ct, train=False)
    assert _counts(spies) == dict(reflect_conv_fwd=2, reflect_conv_dx=1,
                                  reflect_conv_dw=2)
    assert torch.equal(y, _run_blocks(ref, x, ct, train=False)[0])
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_resnet_route_on_auto_forward_and_stats_match_jax(monkeypatch):
    """The reflect ResNet-18 trunk (layer3/4 removed, 32 px: layer1 at 8x8
    chains in both blocks; layer2 at 4x4 does not route) in train mode,
    port ``rconv="on", bn_fuse="auto"`` against JAX under
    ``VIDEOWALK_RCONV=on VIDEOWALK_BN_FUSE=auto``: output rtol 1e-3 + atol
    5e-5, statistics rtol 1e-4 + atol 1e-5 (as the ``stats`` trunk test)."""
    from videowalk_tpu.models.resnet import resnet18 as jax_resnet18

    from videowalk_tpu_torch.models.resnet import resnet18

    monkeypatch.setenv("VIDEOWALK_RCONV", "on")
    monkeypatch.setenv("VIDEOWALK_BN_FUSE", "auto")
    net = jax_resnet18(padding_mode="reflect",
                       remove_layers=("layer3", "layer4"))
    x = _rand((2, 32, 32, 3), 21)
    variables = jax.tree_util.tree_map(np.asarray, dict(
        net.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)))
    y_j, upd = net.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])

    model = resnet18("reflect", ("layer3", "layer4"), rconv="on")
    assert model.layer1[0].bn_fuse == "auto"             # the default
    model.load_state_dict(state_from_flax(variables), strict=True)
    spies = _spy_all(monkeypatch)
    with torch.no_grad():
        y = model(_nchw(x), train=True)
    assert _counts(spies) == dict(reflect_conv_fwd_stats=2,
                                  reflect_conv_fwd_bnin_stats=2)
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), rtol=1e-3,
                               atol=5e-5)
    state = model.state_dict()
    for k, v in state_from_flax({"batch_stats": jax.tree_util.tree_map(
            np.asarray, upd["batch_stats"])}).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_state_from_flax_loads_a_bn_fuse_auto_model(monkeypatch):
    """A JAX CRW built and run in train mode under ``VIDEOWALK_RCONV=on
    VIDEOWALK_BN_FUSE=auto`` (the chain has no parameter of its own)
    carries its weights into the port's ``bn_fuse="auto"`` CRW with
    ``strict=True``, and the train-mode features agree (atol 1e-4 as in
    tests/test_torch_encoder.py, through train-mode BNs: rtol 1e-3)."""
    from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig

    from videowalk_tpu_torch.models import CRW, CRWConfig

    monkeypatch.setenv("VIDEOWALK_RCONV", "on")
    monkeypatch.setenv("VIDEOWALK_BN_FUSE", "auto")
    x = np.random.RandomState(0).rand(2, 1, 32, 32, 3).astype(np.float32)
    layers = ("layer3", "layer4")
    jm = JaxCRW(JaxConfig(model_type="scratch", remove_layers=layers))
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        just_feats=True, train=False)
    (q_j, maps_j), _ = jm.apply(variables, jnp.asarray(x), just_feats=True,
                                train=True, mutable=["batch_stats"])
    model = CRW(CRWConfig(model_type="scratch", remove_layers=layers,
                          rconv="on", bn_fuse="auto"))
    model.load_state_dict(state_from_flax(jax.tree_util.tree_map(
        np.asarray, dict(variables))), strict=True)
    spies = _spy_all(monkeypatch)
    with torch.no_grad():
        q, maps = model(torch.from_numpy(x), just_feats=True, train=True)
    assert _counts(spies) == dict(reflect_conv_fwd_stats=2,
                                  reflect_conv_fwd_bnin_stats=2)
    np.testing.assert_allclose(maps.numpy(), np.asarray(maps_j), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=1e-3,
                               atol=1e-4)
