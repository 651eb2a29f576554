"""The reflect-conv kernels (``videowalk_tpu_torch/ops/rconv.py`` →
``ops/csrc/rconv.cu``): on the card (``-m cuda``, skipped without one) each
of forward (#4), forward with moments (#5), dx (#9) and dW (#10) against
the plain PyTorch version on the same inputs, and the wrapper's refusals.

Tolerances, relative to each output's largest entry: f32 1e-5 (the same
f32 products summed in another order; TF32 off); bf16 y and dW 1e-2 and dx
2e-2 (both sides round f32 sums to bf16 once, ~4e-3, and the plain dx
rounds the padded gradient before folding the pad back, the kernel the
folded gy sum). Moments per channel, s1 relative to that channel's Σ|y| and
s2 to its Σy²: against the kernel's own cast y 1e-5 (the same values summed
in another order); against the plain y f32 1e-5 and bf16 1e-3 (where the
two sides round a y entry to bf16 differently, its channel's sums move by
one bf16 ulp, up to 2^-7 of that entry: ~1e-4 of a 256-row channel's Σ|y|
for an entry of 3 standard deviations).

Runs on the card's machine with ``--noconftest`` (no jax there)."""

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.ops import rconv as rc

torch.set_num_threads(1)

TOL = {torch.float32: dict(y=1e-5, dx=1e-5, dw=1e-5, mom=1e-5, mom_ref=1e-5),
       torch.bfloat16: dict(y=1e-2, dx=2e-2, dw=1e-2, mom=1e-5, mom_ref=1e-3)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(N, cin, cout, H, W, dtype, seed, device="cuda"):
    """x, gy channels_last (N, C, H, W); w (Cout, Cin, 3, 3)."""
    rng = np.random.RandomState(seed)
    cl = torch.channels_last

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    x = t(rng.randn(N, cin, H, W)).contiguous(memory_format=cl)
    w = t(rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin))
    gy = t(rng.randn(N, cout, H, W)).contiguous(memory_format=cl)
    return x, w, gy


def _close(name, got, want, rel):
    got, want = got.float().cpu(), want.float().cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * max(scale, 1e-30), (name, err, scale)


def _moment_err(s1, s2, y):
    """Per channel |s1 - Σy| / Σ|y| and |s2 - Σy²| / Σy² (f32 sums of y),
    the largest over channels."""
    yf = y.float()
    m1, m2 = yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))
    return float(torch.maximum((s1 - m1).abs() / yf.abs().sum((0, 2, 3)),
                               (s2 - m2).abs() / m2).max())


def test_wrappers_refuse_other_devices():
    x = torch.zeros((2, 8, 8, 8), device="meta")
    w = torch.zeros((8, 8, 3, 3), device="meta")
    for call in (lambda: rc.reflect_conv_fwd(x, w),
                 lambda: rc.reflect_conv_fwd_stats(x, w),
                 lambda: rc.reflect_conv_dx(x, w, x),
                 lambda: rc.reflect_conv_dw(x, x, w)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_bnin_chain_is_not_ported():
    with pytest.raises(NotImplementedError, match="slice 4"):
        rc.reflect_conv3x3_bnin_stats(None, None, None, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,cin,cout,H,W", [
    (5, 64, 64, 16, 16),         # layer1, N not a multiple of a tile
    (4, 512, 512, 8, 8),         # layer4 interior
    (5, 128, 256, 8, 8),         # layer3.0.conv1: Cin != Cout
    (3, 256, 128, 8, 8),         # Cout < Cin
    (2, 64, 64, 32, 32),         # 32x32 maps
    (3, 24, 40, 16, 8),          # channel tails, H != W
])
def test_kernels_match_plain_on_card(N, cin, cout, H, W, dtype):
    _need_card()
    tol = TOL[dtype]
    x, w, gy = _inputs(N, cin, cout, H, W, dtype, seed=cin + cout + H)
    y_ref = rc.reflect_conv_plain(x, w)
    dx_ref, dw_ref = rc.reflect_conv_plain_bwd(x, w, gy)
    before = [f.launches for f in (rc.reflect_conv_fwd, rc.reflect_conv_fwd_stats,
                                   rc.reflect_conv_dx, rc.reflect_conv_dw)]
    y = rc.reflect_conv_fwd(x, w)
    ys, s1, s2 = rc.reflect_conv_fwd_stats(x, w)
    dx = rc.reflect_conv_dx(gy, w, x)
    dw = rc.reflect_conv_dw(x, gy, w)
    torch.cuda.synchronize()
    after = [f.launches for f in (rc.reflect_conv_fwd, rc.reflect_conv_fwd_stats,
                                  rc.reflect_conv_dx, rc.reflect_conv_dw)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    assert y.dtype == ys.dtype == dx.dtype == dw.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, ys)
    _close("y", y, y_ref, tol["y"])
    _close("dx", dx, dx_ref, tol["dx"])
    _close("dw", dw, dw_ref, tol["dw"])
    # moments per channel, of the kernel's own cast y and of the plain y
    assert _moment_err(s1, s2, ys) <= tol["mom"]
    assert _moment_err(s1, s2, y_ref) <= tol["mom_ref"]
    # deterministic: no atomics in the moment or dW reductions
    _, s1b, s2b = rc.reflect_conv_fwd_stats(x, w)
    assert torch.equal(s1, s1b) and torch.equal(s2, s2b)
    assert torch.equal(dw, rc.reflect_conv_dw(x, gy, w))


@pytest.mark.cuda
def test_corner_legs_of_dx_on_card():
    """A gradient that is one-hot at each corner and edge midpoint of the
    output: the kernel's dx folds every leg through the pad as the plain
    version's autograd does (f32, exact up to summation order)."""
    _need_card()
    x, w, _ = _inputs(2, 8, 8, 8, 8, torch.float32, seed=3)
    gy = torch.zeros((2, 8, 8, 8), device="cuda")
    for h, ww in ((0, 0), (0, 7), (7, 0), (7, 7), (0, 3), (4, 0), (7, 5),
                  (2, 7)):
        gy[:, :, h, ww] = torch.arange(1, 9, device="cuda", dtype=torch.float32)
    gy = gy.contiguous(memory_format=torch.channels_last)
    _close("dx", rc.reflect_conv_dx(gy, w, x),
           rc.reflect_conv_plain_bwd(x, w, gy)[0], 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_stats_op_matches_plain_on_card(dtype):
    """``reflect_conv3x3_stats`` through autograd with a loss that touches
    y, s1 and s2, against the plain conv and its sums differentiated by
    autograd, on an NCHW input (the op converts it)."""
    _need_card()
    x, w, gy = _inputs(5, 64, 128, 8, 8, dtype, seed=9)
    x = x.contiguous()
    rng = np.random.RandomState(10)
    c1 = torch.from_numpy(rng.randn(128).astype(np.float32)).cuda() * 1e-3
    c2 = torch.from_numpy(rng.randn(128).astype(np.float32)).cuda() * 1e-4
    grads = []
    for fn in (rc.reflect_conv3x3_stats,
               lambda a, b: (lambda y: (y, *rc.moments_plain(y)))(
                   rc.reflect_conv_plain(a, b))):
        xx = x.detach().clone().requires_grad_()
        ww = w.detach().clone().requires_grad_()
        y, s1, s2 = fn(xx, ww)
        ((y.float() * gy.float()).sum() + (s1 * c1).sum()
         + (s2 * c2).sum()).backward()
        grads.append((xx.grad, ww.grad))
    tol = TOL[dtype]
    _close("dx", grads[0][0], grads[1][0], 2 * tol["dx"])
    _close("dw", grads[0][1], grads[1][1], 2 * tol["dw"])


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    _need_card()
    x, w, gy = _inputs(2, 64, 64, 8, 8, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="channels_last"):
        rc.reflect_conv_fwd(x.contiguous(), w)               # NCHW storage
    with pytest.raises(ValueError, match="bf16 or f32"):
        rc.reflect_conv_fwd(x.half(), w.half())
    with pytest.raises(ValueError, match="w must be"):
        rc.reflect_conv_fwd(x, w.float())                    # mixed dtypes
    x12, w12, _ = _inputs(2, 64, 64, 12, 12, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="12x12"):
        rc.reflect_conv_fwd(x12, w12)                        # not a power of 2
    x4, w4, _ = _inputs(2, 64, 64, 4, 4, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="4x4"):
        rc.reflect_conv_fwd_stats(x4, w4)                    # too small
    xc, wc, _ = _inputs(2, 12, 16, 8, 8, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="multiple of 8"):
        rc.reflect_conv_fwd(xc, wc)                          # 12 channels
    with pytest.raises(ValueError, match="shape"):
        rc.reflect_conv_dw(x, gy[:1], w)
    with pytest.raises(ValueError, match=r"\(Cout, 64, 3, 3\)"):
        rc.reflect_conv_fwd(x, w[:, :32])

