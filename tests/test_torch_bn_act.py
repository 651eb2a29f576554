"""Train-mode BatchNorm with its residual add and ReLU
(``videowalk_tpu_torch/ops/bn_act.py``) on the CPU.

``test_plain_path_is_the_chain``: ``BatchNorm.forward`` in train mode
(``bn_act``, which takes the eager chain for CPU tensors) against the chain
the port ran before, written out here: bitwise, in the outputs, both
BNs' running statistics and the gradients to x, weight, bias, the
shortcut (or the projection's input) and the conv's moments.

``test_fused_function_matches_the_chain``: the kernels' autograd function
(``bn_act_fused``) on the passes' plain versions against the same chain:
what the card runs, less the kernels. Its moments' cotangents are folded
into x's gradient (the moments get none), so x's total gradient is
compared. Tolerances: f64 1e-12 of each quantity's largest entry; f32
1e-5 (the same f32 sums in another order); bf16 tensors one bf16 ulp of
each entry (2^-7 of it) plus half an ulp of the largest entry (2^-8 of it:
the chain rounds the BN's part of a gradient to bf16 before it adds the
moments' part, so its error is of an intermediate as large as the largest
entry; the function rounds once), f32 sums at 1e-5.

Cases: moments from the conv / reduced by the BN; no shortcut / identity /
projection; f32 / bf16 / f64; without a group and with a gloo group of one
(the grouped path, one all-reduce forward and one backward, bitwise the
ungrouped one)."""

from __future__ import annotations

import copy

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from videowalk_tpu_torch.models.resnet import BatchNorm, resnet18
from videowalk_tpu_torch.ops import bn_act as ba
from videowalk_tpu_torch.ops import rconv as rc
from videowalk_tpu_torch.parallel.mesh import all_reduce_sum, group_size
from videowalk_tpu_torch.utils import profile

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
N, C, H, W = 3, 8, 5, 4


@pytest.fixture(scope="module")
def group_of_one(tmp_path_factory):
    """A gloo process group of one rank, made here where none is."""
    made = not dist.is_initialized()
    if made:
        store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "s"), 1)
        dist.init_process_group("gloo", store=store, world_size=1, rank=0)
    assert dist.get_world_size() == 1
    yield dist.group.WORLD
    if made:
        dist.destroy_process_group()


def _chain_bn(bn, x, moments):
    """``BatchNorm.forward(x, train=True, moments)`` as the port ran it
    before ``ops/bn_act.py``."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if moments is None:
        mean = xf.mean(dim=(0, 2, 3))
        ex2 = (xf * xf).mean(dim=(0, 2, 3))
    else:
        count = x.numel() // x.shape[1]
        mean, ex2 = moments[0] / count, moments[1] / count
    if bn.group is not None:
        packed = all_reduce_sum(torch.cat([mean, ex2]), bn.group)
        mean, ex2 = (packed / group_size(bn.group)).chunk(2)
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(1 - bn.momentum).add_(mean.detach(),
                                                   alpha=bn.momentum)
        bn.running_var.mul_(1 - bn.momentum).add_(var.detach(),
                                                  alpha=bn.momentum)
        bn.num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] \
        + bn.bias[:, None, None]
    return y.to(bn.dtype)


def _chain(y, bn, moments, shortcut=None, proj=None):
    """A block's last BN, add and ReLU as ``BasicBlock.forward`` ran them:
    ``relu(bn(y) + shortcut)``, the shortcut the projection's BN where
    there is one."""
    z = _chain_bn(bn, y, moments)
    if proj is not None:
        shortcut = _chain_bn(proj[1], proj[0], None)
    return F.relu(z + shortcut) if shortcut is not None else F.relu(z)


def _case(dtype, shortcut, conv_moments, group, seed=0):
    """Leaves and BNs of one case: the BN input x (y = 2x + 1, so a
    channel's mean is off 0), the identity shortcut or the projection's
    input, and the upstream gradient."""
    g = torch.Generator().manual_seed(seed)

    def leaf(scale=1.0, shift=0.0):
        t = torch.randn((N, C, H, W), generator=g, dtype=torch.float64)
        return (t * scale + shift).to(dtype).requires_grad_()

    bn, bn_d = BatchNorm(C, dtype), BatchNorm(C, dtype)
    for m in (bn, bn_d):
        m.to(torch.float64 if dtype == torch.float64 else torch.float32)
        with torch.no_grad():
            m.weight.copy_(torch.rand(C, generator=g) + 0.5)
            m.bias.copy_(torch.rand(C, generator=g) - 0.5)
            m.running_var.copy_(torch.rand(C, generator=g) + 0.5)
    return dict(group=group, x=leaf(2.0, 1.0), r=leaf(), xd=leaf(1.5, -0.5),
                go=torch.randn((N, C, H, W), generator=g,
                               dtype=torch.float64).to(dtype),
                bn=bn, bn_d=bn_d, shortcut=shortcut,
                conv_moments=conv_moments)


def _run(case, fn):
    """Forward and backward of one path on fresh copies of the case's
    leaves and BNs: every quantity the tests compare, by name."""
    leaves = {k: case[k].detach().clone().requires_grad_()
              for k in ("x", "r", "xd")}
    bn, bn_d = copy.deepcopy(case["bn"]), copy.deepcopy(case["bn_d"])
    bn.group = bn_d.group = case["group"]
    y = leaves["x"] * 1
    moments = None
    if case["conv_moments"]:
        yf = y.to(torch.promote_types(y.dtype, torch.float32))
        moments = (yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3)))
        for m in moments:
            m.retain_grad()
    kw = {}
    if case["shortcut"] == "identity":
        kw["shortcut"] = leaves["r"]
    elif case["shortcut"] == "projection":
        kw["proj"] = (leaves["xd"] * 1, bn_d)
    out = fn(y, bn, moments, **kw)
    out.backward(case["go"])
    got = dict(out=out.detach(), x=leaves["x"].grad,
               running_mean=bn.running_mean, running_var=bn.running_var,
               weight=bn.weight.grad, bias=bn.bias.grad)
    if case["shortcut"] == "identity":
        got["r"] = leaves["r"].grad
    if case["shortcut"] == "projection":
        got.update(xd=leaves["xd"].grad, running_mean_d=bn_d.running_mean,
                   running_var_d=bn_d.running_var, weight_d=bn_d.weight.grad,
                   bias_d=bn_d.bias.grad)
    if moments is not None:
        got["s1"], got["s2"] = moments[0].grad, moments[1].grad
    return got


def _module_path(y, bn, moments, **kw):
    return bn(y, True, moments, relu=True, **kw)


def _fused_path(y, bn, moments, **kw):
    return ba.bn_act_fused(y, bn, moments, relu=True, **kw)


def _chain_path(y, bn, moments, **kw):
    return _chain(y, bn, moments, kw.get("shortcut"), kw.get("proj"))


CASES = [pytest.param(d, s, m, grp, id=f"{d}-{s}-{m}-{grp}")
         for d in DTYPES for s in ("none", "identity", "projection")
         for m in ("conv", "own") for grp in ("nogroup", "group1")]


@pytest.mark.parametrize("dtype,shortcut,moments,group", CASES)
def test_plain_path_is_the_chain(dtype, shortcut, moments, group,
                                 request):
    grp = request.getfixturevalue("group_of_one") if group == "group1" \
        else None
    case = _case(DTYPES[dtype], shortcut, moments == "conv", grp)
    want = _run(case, _chain_path)
    got = _run(case, _module_path)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] is not None and want[name] is not None, name
        assert torch.equal(got[name], want[name]), name


def _close(name, got, want, elem, scale):
    got, want = got.double(), want.double()
    tol = elem * want.abs() + scale * max(float(want.abs().max()), 1e-30)
    err = (got - want).abs()
    assert bool((err <= tol).all()), (name, float(err.max()),
                                      float(want.abs().max()))


@pytest.mark.parametrize("dtype,shortcut,moments,group", CASES)
def test_fused_function_matches_the_chain(dtype, shortcut, moments, group,
                                          request):
    grp = request.getfixturevalue("group_of_one") if group == "group1" \
        else None
    case = _case(DTYPES[dtype], shortcut, moments == "conv", grp)
    want = _run(case, _chain_path)
    got = _run(case, _fused_path)
    if moments == "conv":
        # folded into x's gradient: the conv's moments get none
        assert got.pop("s1") is None and got.pop("s2") is None
        want.pop("s1"), want.pop("s2")
    assert got.keys() == want.keys()
    elem, scale = {"f64": (0.0, 1e-12), "f32": (0.0, 1e-5),
                   "bf16": (2.0 ** -7, 2.0 ** -8)}[dtype]
    for name in want:
        if got[name].dtype == torch.bfloat16:
            _close(name, got[name], want[name], elem, scale)
        else:
            _close(name, got[name], want[name], 0.0,
                   1e-12 if dtype == "f64" else 1e-5)


def _block_input(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, 3, 32, 32), generator=g).requires_grad_()


def test_trunk_counts_its_bn_applications():
    """Spans on, one train-mode forward and backward of a ResNet-18 trunk
    inside a ``trunk`` span: ``bn_plain`` counts each of its 20 BNs (the
    stem, 16 in the blocks, 3 projections) once forward and once backward
    on the CPU, and ``bn_fused`` none; eval mode counts nothing."""
    trunk = resnet18("reflect")
    x = _block_input()
    profile.reset()
    profile.enable()
    try:
        with profile.span("step", root=True):
            with profile.span("trunk"):
                out = trunk(x, train=True)
            out.sum().backward()
            with profile.span("trunk"), torch.no_grad():
                trunk(x, train=False)
        counts = profile.summary()["trunk"]["counts"]
    finally:
        profile.disable()
        profile.reset()
    assert counts == {"bn_plain": 40}


def test_a_recompute_counts_its_forwards_only():
    """Under remat each block's recompute counts its BN forwards again,
    and not their backwards, which run once."""
    trunk = resnet18("reflect", remove_layers=("layer3", "layer4"),
                     remat=True, remat_stages="layer1")
    x = _block_input(1)
    profile.reset()
    profile.enable()
    try:
        with profile.span("step", root=True):
            with profile.span("trunk"):
                out = trunk(x, train=True)
            with profile.span("trunk.backward"):
                out.sum().backward()
        spans = profile.summary()
    finally:
        profile.disable()
        profile.reset()
    assert spans["trunk.backward"]["counts"] == {"bn_plain": 4}
    counts = {"bn_plain": sum(spans[k]["counts"]["bn_plain"]
                              for k in ("trunk", "trunk.backward"))}
    # stem 1 + layer1 4 + layer2 5 (with its projection), forward and
    # backward; layer1's 4 forwards again in the recompute
    assert counts == {"bn_plain": 2 * 10 + 4}


def test_folded_moments_leave_the_conv_gradient():
    """A conv whose moments' cotangents the BN folded itself (both None)
    passes its output's gradient on unchanged; one None cotangent counts
    as 0."""
    g = torch.Generator().manual_seed(2)
    y = torch.randn((2, 4, 3, 3), generator=g)
    gy = torch.randn((2, 4, 3, 3), generator=g)
    gs = torch.randn((4,), generator=g)
    assert rc._fold_moment_cotangents(gy, None, None, y) is gy
    want = ba.fold_plain(gy, gs, torch.zeros(4), y)
    assert torch.equal(rc._fold_moment_cotangents(gy, gs, None, y), want)


def test_wrappers_refuse_cuda_operands_they_do_not_take():
    """The kernel wrappers' checks, reachable on the CPU: a CUDA device is
    required before anything is launched."""
    y = torch.zeros((1, 8, 2, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        ba._check("bn_act_fwd", y)
    with pytest.raises(ValueError, match="NCHW or channels_last"):
        ba._nchw("bn_act_fwd", "y", y.permute(0, 2, 1, 3))


def test_eval_mode_is_untouched():
    """Eval mode keeps ``F.batch_norm`` on the running statistics, then the
    add and the ReLU, as before."""
    case = _case(torch.float32, "projection", False, None, seed=3)
    bn, bn_d = case["bn"], case["bn_d"]
    bn.eval(), bn_d.eval()
    y, xd = case["x"].detach(), case["xd"].detach()
    got = bn(y, False, proj=(xd, bn_d), relu=True)
    want = F.relu(
        F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     False, 0.0, bn.eps)
        + F.batch_norm(xd, bn_d.running_mean, bn_d.running_var,
                       bn_d.weight, bn_d.bias, False, 0.0, bn_d.eps))
    assert torch.equal(got, want)
