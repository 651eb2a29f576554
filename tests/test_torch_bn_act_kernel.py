"""The BN kernels (``videowalk_tpu_torch/ops/bn_act.py`` →
``ops/csrc/bn_act.cu``) on the card (``-m cuda``, skipped without one):
the kernels' autograd function against the eager chain on the same CUDA
inputs at the flagship's layer4 (12,544 images of 8x8x512, channels_last:
an identity shortcut with the conv's moments, a projection with its own)
and at the superpixel step's 64x64 layer1 (640 frames x 64 channels, NCHW,
as cuDNN gives it: a block's bn1 with its own moments and ReLU, and its
bn2 with the identity); each pass against its plain version at small
shapes in both types and layouts, mixed layouts and the one-element-a-lane
path; bitwise repeats; two planted faults that the comparison must catch;
the wrappers' refusals; and a small f32 trunk's train step card vs CPU,
with every BN counted on the kernels.

Limits of the comparison with the chain (bf16): the output bitwise where
the moments come from the conv, else within one bf16 ulp of each rounded
operand, ``T(BN(y))``, the shortcut ``r`` and the output (the same rounded
f32 operations, but a BN that reduces its own moments sums them in another
order, so the two sides may round ``T(BN(y))`` and ``T(BN_d(yd))`` to
neighbouring values, and a sum that cancels keeps both ulps); dy, dshortcut
and dyd one ulp of each entry plus half an ulp of the tensor's largest
entry (the chain rounds the BN's part of a gradient before adding the
moments' part, the kernels round once); dweight, dbias and the running
statistics 1e-4 of their largest entry (f32 sums over 0.8-2.6 M elements a
channel in another order). Where the moments differ in their last bits,
an output near 0 may pass the ReLU on one side only: ``_check`` bounds
those entries and what their gradients add to the sums.

Runs on the card's machine with ``--noconftest`` (no jax there)."""

from __future__ import annotations

import copy
import functools

import pytest
import torch

from videowalk_tpu_torch.models.resnet import BatchNorm, resnet18
from videowalk_tpu_torch.ops import bn_act as ba
from videowalk_tpu_torch.utils import profile

ULP = 2.0 ** -7          # of a bf16 entry, relative


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _t(shape, gen, dtype, nchw, scale=1.0, shift=0.0):
    t = (torch.randn(shape, generator=gen, device="cuda") * scale
         + shift).to(dtype)
    return t if nchw else t.contiguous(memory_format=torch.channels_last)


def _bns(C, dtype, gen):
    out = []
    for _ in range(2):
        m = BatchNorm(C, dtype).cuda()
        with torch.no_grad():
            m.weight.copy_(torch.rand(C, generator=gen, device="cuda") + 0.5)
            m.bias.copy_(torch.rand(C, generator=gen, device="cuda") - 0.5)
        out.append(m)
    return out


def _run(fn, y0, bn, bn_d, go, shortcut, conv_moments, r0=None, yd0=None,
         relu=True):
    """One path's forward and backward: every compared quantity."""
    bn, bn_d = copy.deepcopy(bn), copy.deepcopy(bn_d)
    y = y0.detach().clone().requires_grad_()
    kw, leaves = {}, {}
    if shortcut == "identity":
        leaves["r"] = r0.detach().clone().requires_grad_()
        kw["shortcut"] = leaves["r"]
    elif shortcut == "projection":
        leaves["yd"] = yd0.detach().clone().requires_grad_()
        kw["proj"] = (leaves["yd"], bn_d)
    moments = None
    if conv_moments:
        # as a conv's epilogue gives them: the chain's gradient reaches y
        # through them, the kernels fold it into y's
        yf = y.float()
        moments = (yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3)))
    out = fn(y, bn, moments, relu=relu, **kw)
    out.backward(go)
    got = dict(out=out.detach(), y=y.grad, weight=bn.weight.grad,
               bias=bn.bias.grad, running_mean=bn.running_mean,
               running_var=bn.running_var)
    for k, v in leaves.items():
        got[k] = v.grad
    if shortcut == "projection":
        got.update(weight_d=bn_d.weight.grad, bias_d=bn_d.bias.grad,
                   running_var_d=bn_d.running_var)
    return got


def _inputs(y, bn, bn_d, go, shortcut, conv_moments, r=None, yd=None):
    """What the limits need of a case: |T(BN(y))| + |r| of the chain (r
    the shortcut or T(BN_d(yd)): the rounded operands of the output's
    sum), and go, y, yd with each BN's batch mean and rsqrt(var + eps)
    (f64, for the sums' slack at flipped gates)."""
    bn, bn_d = copy.deepcopy(bn), copy.deepcopy(bn_d)
    with torch.no_grad():
        moments = ba.moments_plain(y) if conv_moments else None
        mag = ba._bn_plain(y, bn, moments, False).double().abs()
        if shortcut == "identity":
            mag += r.double().abs()
        elif shortcut == "projection":
            mag += ba._bn_plain(yd, bn_d, None, False).double().abs()

    def stats(t):
        t = t.double()
        m = t.mean((0, 2, 3))
        v = (t * t).mean((0, 2, 3)) - m * m
        return t, m, torch.rsqrt(v.clamp_min(0) + bn.eps)

    out = dict(operands=mag, go=go.double(), y=stats(y))
    if shortcut == "projection":
        out["yd"] = stats(yd)
    return out


def _per_channel(t):
    return t.sum((0, 2, 3))


def _check(got, want, case):
    """The limits of the module docstring; raises AssertionError naming
    every quantity out of them.

    A ReLU gate may flip where the output rounds to 0 on one side and to a
    value within its limit of 0 on the other (a BN that reduces its own
    moments): such entries must be under 1e-5 of the tensor; their
    gradients are then left out of the elementwise limits, and their
    contributions (|go|, |go·(y − mean)·inv|) are added to the limits of
    the per-channel sums."""
    faults = []
    w_out, g_out = want["out"].double(), got["out"].double()
    tol_out = ULP * (w_out.abs() + case["operands"])
    err = (g_out - w_out).abs()
    if bool((err > tol_out).any()):
        faults.append(("out", int((err > tol_out).sum()), float(err.max())))
    flip = (g_out > 0) != (w_out > 0)
    if bool(flip.any()):
        near = (g_out.abs() <= tol_out) & (w_out.abs() <= tol_out)
        if not bool(near[flip].all()) or float(flip.double().mean()) > 1e-5:
            faults.append(("gates", int(flip.sum())))
    keep = ~flip
    go_f = case["go"].abs() * flip
    slack = dict(bias=_per_channel(go_f))
    y, m, inv = case["y"]
    slack["weight"] = _per_channel(go_f * (y - m[:, None, None]).abs()
                                   * inv[:, None, None])
    if "yd" in case:
        yd, md, invd = case["yd"]
        slack["bias_d"] = slack["bias"]
        slack["weight_d"] = _per_channel(
            go_f * (yd - md[:, None, None]).abs() * invd[:, None, None])
    for name, w in want.items():
        if name == "out":
            continue
        g = got[name]
        assert g is not None and g.shape == w.shape, name
        gd, wd = g.double(), w.double()
        err = (gd - wd).abs()
        if g.dtype == torch.bfloat16:
            tol = ULP * wd.abs() + ULP / 2 * float(wd.abs().max())
            bad = int(((err > tol) & keep).sum())
        else:
            tol = 1e-4 * float(wd.abs().max()) + slack.get(name, 0.0)
            bad = int((err > tol).sum())
        if bad:
            faults.append((name, bad, float(err.max()),
                           float(wd.abs().max())))
    assert not faults, faults


# (N, C, H, W, nchw, shortcut, conv moments, relu): the cases at the
# trunk's own shapes
FLAGSHIP = [
    pytest.param(12544, 512, 8, 8, False, "identity", True, id="layer4-identity"),
    pytest.param(12544, 512, 8, 8, False, "projection", True,
                 id="layer4-projection"),
    pytest.param(640, 64, 64, 64, True, "none", False, id="sp-layer1-bn1"),
    pytest.param(640, 64, 64, 64, True, "identity", False,
                 id="sp-layer1-bn2"),
]


def _flagship_case(N, C, H, W, nchw, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    y = _t((N, C, H, W), gen, bf, nchw, 2.0, 0.5)
    r = _t((N, C, H, W), gen, bf, nchw)
    yd = _t((N, C, H, W), gen, bf, nchw, 1.5, -0.3)
    go = _t((N, C, H, W), gen, bf, nchw)
    bn, bn_d = _bns(C, bf, gen)
    return y, r, yd, go, bn, bn_d


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,H,W,nchw,shortcut,conv_moments", FLAGSHIP)
def test_kernels_match_the_chain_on_card(N, C, H, W, nchw, shortcut,
                                         conv_moments):
    _need_card()
    y, r, yd, go, bn, bn_d = _flagship_case(N, C, H, W, nchw)
    args = (y, bn, bn_d, go, shortcut, conv_moments, r, yd)
    before = ba.bn_act_fwd.launches
    got = _run(ba.bn_act_fused, *args)
    assert ba.bn_act_fwd.launches == before + 1
    want = _run(ba.bn_act_plain, *args)
    _check(got, want, _inputs(*args))
    if conv_moments and shortcut != "projection":
        # the same moments, the same rounded operations
        assert torch.equal(got["out"], want["out"])
    layout = (torch.contiguous_format if nchw else torch.channels_last)
    assert got["out"].is_contiguous(memory_format=layout)
    assert got["y"].is_contiguous(memory_format=layout)


@pytest.mark.cuda
def test_kernels_repeat_bitwise_on_card():
    _need_card()
    y, r, yd, go, bn, bn_d = _flagship_case(1568, 512, 8, 8, False, seed=1)
    runs = [_run(ba.bn_act_fused, y, bn, bn_d, go, "projection", False,
                 r, yd) for _ in range(2)]
    for name in runs[0]:
        assert torch.equal(runs[0][name], runs[1][name]), name


class _Fault:
    """A planted fault at the kernels' boundary: ``drop_s2`` zeroes one
    channel's Σy² as the moments kernel returns it; ``gate_tile`` inverts
    the ReLU gate on one tile (32 images x 64 channels) of what the
    backward's passes see."""

    def __init__(self, monkeypatch, kind):
        self.kind = kind
        if kind == "drop_s2":
            real = ba.bn_moments

            @functools.wraps(real)          # keeps its launch count
            def moments(y):
                s1, s2 = real(y)
                s2 = s2.clone()
                s2[5] = 0.0
                return s1, s2

            monkeypatch.setattr(ba, "bn_moments", moments)
        else:
            for name in ("bn_act_reduce_bwd", "bn_act_apply_bwd"):
                monkeypatch.setattr(ba, name, self._gate(getattr(ba, name)))

    @staticmethod
    def _gate(real):
        @functools.wraps(real)
        def wrapped(go, out, *rest):
            flipped = out.clone()
            tile = flipped[:32, :64]
            tile.copy_((tile <= 0).to(tile.dtype))
            return real(go, flipped, *rest)
        return wrapped


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["drop_s2", "gate_tile"])
def test_planted_faults_fail_the_check_on_card(monkeypatch, fault):
    _need_card()
    y, r, yd, go, bn, bn_d = _flagship_case(1568, 512, 8, 8, False, seed=2)
    args = (y, bn, bn_d, go, "projection", False, r, yd)
    want = _run(ba.bn_act_plain, *args)
    case = _inputs(*args)
    _check(_run(ba.bn_act_fused, *args), want, case)
    _Fault(monkeypatch, fault)
    with pytest.raises(AssertionError):
        _check(_run(ba.bn_act_fused, *args), want, case)


# (N, C, H, W, dtype, y's layout, the shortcut's layout)
SMALL = [
    pytest.param(6, 64, 8, 8, torch.bfloat16, "cl", "cl", id="bf16-cl"),
    pytest.param(6, 64, 8, 8, torch.bfloat16, "nchw", "nchw", id="bf16-nchw"),
    pytest.param(6, 64, 16, 16, torch.bfloat16, "cl", "nchw", id="bf16-mixed"),
    pytest.param(6, 128, 8, 8, torch.bfloat16, "nchw", "cl",
                 id="bf16-mixed-nchw"),
    pytest.param(5, 24, 8, 8, torch.float32, "cl", "cl", id="f32-cl"),
    pytest.param(5, 24, 6, 6, torch.float32, "nchw", "cl", id="f32-mixed"),
    pytest.param(3, 12, 5, 5, torch.bfloat16, "cl", "cl", id="bf16-lanes1-cl"),
    pytest.param(3, 12, 5, 5, torch.bfloat16, "nchw", "nchw",
                 id="bf16-lanes1-nchw"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,H,W,dtype,lay,sc_lay", SMALL)
def test_passes_match_plain_on_card(N, C, H, W, dtype, lay, sc_lay):
    """Each pass wrapper's kernel against its plain version on the same
    inputs: forward and fold bitwise (the same rounded f32 operations), the
    apply pass within one ulp of each entry (a fused multiply-add), the
    sums within 1e-5 of each channel's sum of magnitudes."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    y = _t((N, C, H, W), gen, dtype, lay == "nchw", 2.0, 0.5)
    sc = _t((N, C, H, W), gen, dtype, sc_lay == "nchw")
    go = _t((N, C, H, W), gen, dtype, lay == "nchw")
    out = _t((N, C, H, W), gen, dtype, lay == "nchw")
    prm = torch.randn((6, C), generator=gen, device="cuda")
    prm[1] = prm[1].abs() + 0.5

    def plain(fn, *a):
        return fn(*[t.cpu() if isinstance(t, torch.Tensor) else t
                    for t in a])

    s1, s2 = ba.bn_moments(y)
    p1, p2 = plain(ba.bn_moments, y)
    yc = ba._wide(y.cpu())
    assert bool(((s1.cpu() - p1).abs()
                 <= 1e-5 * yc.abs().sum((0, 2, 3))).all())
    assert bool(((s2.cpu() - p2).abs()
                 <= 1e-5 * (yc * yc).sum((0, 2, 3))).all())
    for mode, relu in ((ba.PLAIN, True), (ba.IDENTITY, True),
                       (ba.PROJ, True), (ba.PROJ, False)):
        sc_m = None if mode == ba.PLAIN else sc
        p = prm if mode == ba.PROJ else prm[:3]
        assert torch.equal(ba.bn_act_fwd(y, p, sc_m, mode, relu).cpu(),
                           plain(ba.bn_act_fwd, y, p, sc_m, mode, relu))
        yd = sc if mode == ba.PROJ else None
        means = prm[[0, 3]] if mode == ba.PROJ else prm[:1]
        sums, dr = ba.bn_act_reduce_bwd(go, out, y, yd, means, mode, relu)
        psums, pdr = plain(ba.bn_act_reduce_bwd, go, out, y, yd, means, mode,
                           relu)
        g = ba._gated(go.cpu(), out.cpu(), relu).abs()
        mags = [g.sum((0, 2, 3)),
                (g * (ba._wide(y.cpu()) - means[0].cpu()[None, :, None, None])
                 .abs()).sum((0, 2, 3))]
        if mode == ba.PROJ:
            mags.append((g * (ba._wide(yd.cpu())
                              - means[1].cpu()[None, :, None, None]).abs())
                        .sum((0, 2, 3)))
        assert bool(((sums.cpu() - psums).abs()
                     <= 1e-5 * torch.stack(mags) + 1e-30).all()), mode
        if mode == ba.IDENTITY:
            assert torch.equal(dr.cpu(), pdr)
        amode = ba.PROJ if mode == ba.PROJ else ba.PLAIN
        dy, dyd = ba.bn_act_apply_bwd(go, out, y, yd, p, amode, relu)
        pdy, pdyd = plain(ba.bn_act_apply_bwd, go, out, y, yd, p, amode, relu)
        for name, a, b in (("dy", dy, pdy), ("dyd", dyd, pdyd)):
            if b is None:
                assert a is None
                continue
            err = (a.cpu().double() - b.double()).abs()
            tol = (ULP if dtype == torch.bfloat16 else 2.0 ** -20) \
                * b.double().abs() + 1e-4
            assert bool((err <= tol).all()), (name, mode)
        if mode == ba.PROJ:
            assert dyd.stride() == sc.stride()
    gs1, gs2 = prm[4], prm[5]
    assert torch.equal(ba.bn_fold(go, gs1, gs2, y).cpu(),
                       ba.fold_plain(go.cpu(), gs1.cpu(), gs2.cpu(), y.cpu()))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    _need_card()
    y = torch.zeros((2, 16, 4, 4), device="cuda", dtype=torch.bfloat16)
    prm = torch.zeros((3, 16), device="cuda")
    with pytest.raises(ValueError, match="NCHW or channels_last"):
        ba.bn_act_fwd(y.permute(0, 1, 3, 2), prm, None, ba.PLAIN, True)
    with pytest.raises(ValueError, match="bf16 or f32"):
        ba.bn_moments(y.double())
    with pytest.raises(ValueError, match="shortcut|sc is"):
        ba.bn_act_fwd(y, prm, y.float(), ba.IDENTITY, True)
    wide = torch.zeros((1, 4096, 1, 2), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels"):
        ba.bn_moments(wide.contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError, match=r"\(3, 16\) float32"):
        ba.bn_act_fwd(y, prm.double(), None, ba.PLAIN, True)


@pytest.mark.cuda
def test_small_trunk_step_card_vs_cpu():
    """A small f32 ResNet-18 trunk in train mode, forward and backward, on
    the card (every BN on the kernels, counted as such) and on the CPU
    (the eager chain): the output and the running statistics within 1e-3
    of each tensor's largest entry, each gradient within 1e-2 relative in
    L2 (``chip_smoke.py``'s card-vs-CPU step takes 2e-2 over all: f32
    sums in other orders, amplified by BN's backward at 256 pixels a
    channel; TF32 off); a wiring fault moves them by O(1)."""
    _need_card()
    torch.manual_seed(0)
    cpu = resnet18("reflect")
    card = resnet18("reflect").cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((4, 3, 64, 64))
    outs = {}
    profile.reset()
    profile.enable()
    try:
        for name, model, xx in (("cpu", cpu, x), ("card", card, x.cuda())):
            with profile.span(f"trunk.{name}"):
                out = model(xx, train=True)
            out.square().mean().backward()
            outs[name] = (out.detach().cpu(),
                          {k: p.grad.cpu() for k, p in
                           model.named_parameters()},
                          {k: b.cpu() for k, b in model.named_buffers()})
        spans = profile.summary()
    finally:
        profile.disable()
        profile.reset()
    assert spans["trunk.card"]["counts"] == {"bn_fused": 40}
    assert spans["trunk.cpu"]["counts"] == {"bn_plain": 40}
    (o1, g1, b1), (o2, g2, b2) = outs["cpu"], outs["card"]

    def close(name, a, b):
        scale = max(float(a.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-3 * scale, name

    close("out", o1, o2)
    for k in b1:
        close(k, b1[k].double(), b2[k].double())
    rel = {k: float((g1[k] - g2[k]).norm() / g1[k].norm().clamp_min(1e-30))
           for k in g1}
    assert max(rel.values()) <= 1e-2, sorted(rel.items(), key=lambda kv:
                                             -kv[1])[:5]
