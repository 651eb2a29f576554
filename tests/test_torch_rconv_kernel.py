"""The reflect-conv kernels (``videowalk_tpu_torch/ops/rconv.py`` →
``ops/csrc/rconv_slab.cu`` for every bf16 kernel, ``ops/csrc/rconv.cu``
for every f32 one): on
the card (``-m cuda``, skipped without one) each of forward (#4), forward
with moments (#5), dx (#9), dW (#10) and the BN-input chain's forward (#6),
dx with da/db (#7) and dW (#8) against the plain PyTorch version on the same
inputs, which engine each dtype reaches, and the wrapper's refusals.

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

The BN-input kernels gate by ``fmaf(x, a, b) > 0`` and the plain version by
``x*a + b > 0`` with the product rounded first, so an element whose
pre-activation lies within one f32 rounding of 0 may be kept on one side
and dropped on the other: it then contributes ~1e-7 of a typical entry to
y and dW, and a whole ``dxn`` entry to one dx element. The limits below
are the plain kernels' (bf16: the rebuilt xn is rounded to bf16 on both
sides from pre-activations that may differ in the last f32 bit, one bf16
ulp of one operand entry); da and db are held per channel to 1e-5 (f32:
the same products summed in another order; largest reading at these shapes
7.4e-7) and 5e-3 (bf16, where the plain dxn sums unrounded boundary legs
and the kernel rounds each leg sum to bf16, over 192-1280 pixels a
channel; largest reading 9.0e-4) of that channel's Σ|dxn·g·x| and
Σ|dxn·g|.

Runs on the card's machine with ``--noconftest`` (no jax there)."""

import importlib.util
import os

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
    a = torch.zeros((8,), device="meta")
    for call in (lambda: rc.reflect_conv_fwd(x, w),
                 lambda: rc.reflect_conv_fwd_stats(x, w),
                 lambda: rc.reflect_conv_dx(x, w, x),
                 lambda: rc.reflect_conv_dw(x, x, w),
                 lambda: rc.reflect_conv_fwd_bnin_stats(x, a, a, w),
                 lambda: rc.reflect_conv_dx_bnin(x, w, x, a, a),
                 lambda: rc.reflect_conv_dw_bnin(x, a, a, x, w)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_build_keeps_the_ptxas_log_beside_the_library(monkeypatch, tmp_path):
    """Each built library keeps nvcc's output (the ptxas report that
    ``chip_smoke.py`` reads ``wgmma`` verdicts from) beside it, so a later
    process that finds the library built still reads its log."""
    from videowalk_tpu_torch.ops import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
                    "echo \"ptxas info    : Used 90 registers\"\n"
                    ": > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    assert _build.build_log("rconv_slab") is None
    logs = _build.build_all(["rconv_slab"])
    assert logs == {"rconv_slab": "ptxas info    : Used 90 registers\n"}
    assert _build.build_all(["rconv_slab"]) == {}     # up to date: not rebuilt
    assert _build.build_log("rconv_slab") == logs["rconv_slab"]
    lib, _ = _build._target("rconv_slab")
    os.unlink(lib)
    assert _build.build_log("rconv_slab") is None     # a log without its library


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# ptxas's name of rconv_slab_px<128, FWD_STATS>: the tensor map first
_PX_MANGLED = ("_ZN46_GLOBAL__N__3f08cc69_13_rconv_slab_cu_1d4e251213rconv_slab_px"
               "ILi128ELi2EEEv14CUtensorMap_stPK13__nv_bfloat16PS2_NS_5PxAuxE"
               "NS_3GeoEiii")


def test_wgmma_verdicts_read_a_ptxas_log():
    """``chip_smoke.py`` names each slab kernel's instantiation and whether
    ptxas serialized its ``wgmma`` (C7515; C7512, which names "the
    function" with "for"), from ptxas's own lines."""
    smoke = _chip_smoke()
    fn = _PX_MANGLED
    dx_bnin = fn.replace("ILi128ELi2EE", "ILi128ELi1EE")
    log = "\n".join((
        f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'",
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to non wgmma instructions defining "
        f"accumulator registers in the function '{fn}'",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113"
        "rconv_slab_pxILi64ELi0EEEv14CUtensorMap_stPK13__nv_bfloat16' for "
        "'sm_90a'",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113"
        "rconv_slab_dwILb1EEEvPK13__nv_bfloat16' for 'sm_90a'",
        f"ptxas info    : Compiling entry function '{dx_bnin}' for 'sm_90a'",
        "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to insufficient register resources "
        f"for the function '{dx_bnin}'",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111"
        "reduce_rowsILi8EEEvPKfPfix' for 'sm_90a'"))
    assert smoke.px_modes() == ["DX", "DX_BNIN", "FWD_STATS", "FWD_BNIN_STATS",
                                "FWD"]
    got = smoke.wgmma_verdicts(log)
    assert set(got) == {"rconv_slab_px<128, FWD_STATS>", "rconv_slab_px<64, DX>",
                        "rconv_slab_dw<true>", "rconv_slab_px<128, DX_BNIN>"}
    assert got["rconv_slab_px<128, FWD_STATS>"].startswith("serialized (C7515")
    assert got["rconv_slab_px<128, DX_BNIN>"].startswith("serialized (C7512")
    assert got["rconv_slab_px<64, DX>"] == "not serialized"
    assert got["rconv_slab_dw<true>"] == "not serialized"


def test_ptxas_resources_read_a_ptxas_log():
    """``chip_smoke.py`` reads each slab kernel's registers and spill bytes
    from ptxas's ``-v`` lines, and nothing of other functions."""
    smoke = _chip_smoke()
    other = "_ZN12_GLOBAL__N_111reduce_rowsILi8EEEvPKfPfix"
    log = "\n".join((
        f"ptxas info    : Compiling entry function '{_PX_MANGLED}' for 'sm_90a'",
        f"ptxas info    : Function properties for {_PX_MANGLED}",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 112 registers, used 2 barriers, 528 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{other}' for 'sm_90a'",
        f"ptxas info    : Function properties for {other}",
        "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 16 registers, 384 bytes cmem[0]"))
    assert smoke.ptxas_resources(log) == {
        "rconv_slab_px<128, FWD_STATS>": dict(registers=112, spill_stores=8,
                                              spill_loads=12)}


@pytest.mark.cuda
def test_px_kernels_keep_wgmma_verdicts_without_spills_on_card():
    """ptxas's verdicts on the build of ``rconv_slab.cu``: none of the ten
    pixel-tiled instantiations (BN 64 and 128, five modes) has its
    ``wgmma`` serialized for an operand defined inside the pipeline or an
    accumulator moved across it (C7510, C7513, C7515), and none spills.
    Two blocks of nine warps an SM leave 96 registers a thread: ptxas
    serializes the five BN 128 instantiations' ``wgmma`` for want of
    registers (C7512), a layout that measured faster than one block an SM
    with 168 registers and no serialization (``PERF.md``); no other slab
    kernel is serialized at all."""
    _need_card()
    from videowalk_tpu_torch.ops import _build

    rc._slab_lib()                                   # built, with its log
    log = _build.build_log("rconv_slab")
    assert log is not None
    smoke = _chip_smoke()
    verdicts, res = smoke.wgmma_verdicts(log), smoke.ptxas_resources(log)
    px = {f"rconv_slab_px<{bn}, {m}>" for bn in (64, 128)
          for m in smoke.px_modes()}
    assert px <= set(verdicts) and px <= set(res)
    for name in sorted(px):
        assert not any(code in verdicts[name]
                       for code in ("C7510", "C7513", "C7515")), (
            name, verdicts[name])
        assert res[name]["spill_stores"] == res[name]["spill_loads"] == 0, (
            name, res[name])
    bn128 = {name for name in px if name.startswith("rconv_slab_px<128")}
    assert {name for name, v in verdicts.items()
            if v.startswith("serialized (C7512")} == bn128, verdicts
    assert all(v == "not serialized" for name, v in verdicts.items()
               if name not in bn128), verdicts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,cin,cout,H,W", [
    (5, 64, 64, 16, 16),         # layer1, N not a multiple of a tile
    (4, 512, 512, 8, 8),         # layer4 interior
    (5, 128, 256, 8, 8),         # layer3.0.conv1: Cin != Cout
    (3, 256, 128, 8, 8),         # Cout < Cin
    (2, 64, 64, 32, 32),         # 32x32 maps
    (3, 24, 40, 16, 8),          # channel tails, H != W
    (7, 64, 96, 8, 8),           # odd N of 8x8: the last dx tile half empty
    (3, 200, 72, 32, 32),        # Cin, Cout not a multiple of any tile
    (1, 136, 520, 8, 32),        # W = 32 on 8 rows, ragged channel tiles
    (2, 512, 512, 16, 16),       # 16x16 bands of whole rows
    (3, 24, 64, 8, 8),           # a channel tail inside a K chunk, the
                                 # narrow tile, M = 192: a ragged last tile
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
    assert torch.equal(y, ys)            # one main loop: the same sums
    _close("y", y, y_ref, tol["y"])
    _close("ys", ys, y_ref, tol["y"])
    _close("dx", dx, dx_ref, tol["dx"])
    _close("dw", dw, dw_ref, tol["dw"])
    # moments per channel, of the kernel's own cast y and of the plain y
    assert _moment_err(s1, s2, ys) <= tol["mom"]
    assert _moment_err(s1, s2, y_ref) <= tol["mom_ref"]
    # deterministic: no atomics in the moment or dW reductions
    ysb, s1b, s2b = rc.reflect_conv_fwd_stats(x, w)
    assert torch.equal(ys, ysb)
    assert torch.equal(s1, s1b) and torch.equal(s2, s2b)
    assert torch.equal(dw, rc.reflect_conv_dw(x, gy, w))
    assert torch.equal(y, rc.reflect_conv_fwd(x, w))


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
@pytest.mark.parametrize("H,W", [(8, 8), (16, 16), (32, 32), (8, 32)])
def test_corner_legs_of_bf16_dx_on_card(H, W):
    """The same one-hot gradients at every border pixel of a map, in bf16
    on ``rconv_slab.cu``'s leg sums: small integers in gy and w, so every
    product, leg sum and f32 sum is exact; the kernel rounds the exact
    integer to bf16 once, as ``want.bfloat16()`` does."""
    _need_card()
    rng = np.random.RandomState(H + W)
    x = torch.zeros((3, 16, H, W), device="cuda", dtype=torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.randint(-2, 3, (16, 16, 3, 3)).astype(np.float32))
    gy = torch.zeros((3, 16, H, W))
    border = torch.zeros((H, W), dtype=torch.bool)
    border[[0, 1, H - 2, H - 1], :] = True
    border[:, [0, 1, W - 2, W - 1]] = True
    gy[:, :, border] = torch.from_numpy(
        rng.randint(-3, 4, (3, 16, int(border.sum()))).astype(np.float32))
    w, gy = w.cuda().bfloat16(), gy.cuda().bfloat16()
    gy = gy.contiguous(memory_format=torch.channels_last)
    got = rc.reflect_conv_dx(gy, w, x)
    want = rc.reflect_conv_plain_bwd(x.float(), w.float(), gy.float())[0]
    assert torch.equal(got.cpu(), want.bfloat16().cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W", [(33, 8, 8), (6, 32, 32)])
def test_dw_repeats_bitwise_on_card(N, H, W):
    """bf16 dW over many K splits: two runs are bitwise equal (fixed-order
    partial sums, no float atomics)."""
    _need_card()
    x, w, gy = _inputs(N, 512, 512, H, W, torch.bfloat16, seed=21)
    first = rc.reflect_conv_dw(x, gy, w)
    for _ in range(2):
        assert torch.equal(first, rc.reflect_conv_dw(x, gy, w))


class _Spy:
    """A kernel library whose calls are logged by entry name."""

    def __init__(self, lib, log):
        self._lib, self._log = lib, log

    def __getattr__(self, name):
        fn = getattr(self._lib, name)

        def call(*args):
            self._log.append(name)
            return fn(*args)
        return call


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W", [(33, 8, 8), (6, 32, 32)])
def test_forward_stats_repeat_bitwise_on_card(N, H, W):
    """bf16 #4, #5 and #6 over many 128-pixel tiles: two runs of y, s1 and
    s2 are bitwise equal (fixed-order row-group and per-tile sums, no float
    atomics)."""
    _need_card()
    x, w, _ = _inputs(N, 512, 512, H, W, torch.bfloat16, seed=24)
    a, b = _affine(512, seed=25)
    first = (rc.reflect_conv_fwd(x, w), *rc.reflect_conv_fwd_stats(x, w),
             *rc.reflect_conv_fwd_bnin_stats(x, a, b, w))
    for _ in range(2):
        again = (rc.reflect_conv_fwd(x, w), *rc.reflect_conv_fwd_stats(x, w),
                 *rc.reflect_conv_fwd_bnin_stats(x, a, b, w))
        assert all(torch.equal(p, q) for p, q in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,entries", [
    (torch.bfloat16, ("rconv_slab_fwd_launch", "rconv_slab_fwd_stats_launch",
                      "rconv_slab_fwd_bnin_stats_launch")),
    (torch.float32, ("rconv_fwd_launch", "rconv_fwd_launch",
                     "rconv_fwd_bnin_launch")),
])
def test_forward_engine_by_dtype_on_card(dtype, entries, monkeypatch):
    """bf16 forwards, alone (#4) and with moments, of the plain conv (#5)
    and of the BN-input chain (#6), launch ``rconv_slab.cu``'s kernels;
    every f32 forward stays on ``rconv.cu``'s engine; each wrapper counts
    one launch either way."""
    _need_card()
    log = []
    lib, slab_lib = rc._lib(), rc._slab_lib()
    monkeypatch.setattr(rc, "_lib", lambda: _Spy(lib, log))
    monkeypatch.setattr(rc, "_slab_lib", lambda: _Spy(slab_lib, log))
    x, w, _ = _inputs(2, 64, 64, 8, 8, dtype, seed=5)
    a, b = _affine(64, seed=6)
    wrappers = (rc.reflect_conv_fwd, rc.reflect_conv_fwd_stats,
                rc.reflect_conv_fwd_bnin_stats)
    before = [f.launches for f in wrappers]
    rc.reflect_conv_fwd(x, w)
    rc.reflect_conv_fwd_stats(x, w)
    rc.reflect_conv_fwd_bnin_stats(x, a, b, w)
    torch.cuda.synchronize()
    assert tuple(n for n in log if n.endswith("_launch")) == entries
    assert [f.launches - n for f, n in zip(wrappers, before)] == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,entries", [
    (torch.bfloat16, ("rconv_slab_dx_launch", "rconv_slab_dw_launch",
                      "rconv_slab_dx_bnin_launch", "rconv_slab_dw_bnin_launch")),
    (torch.float32, ("rconv_dx_launch", "rconv_dw_launch",
                     "rconv_dx_bnin_launch", "rconv_dw_bnin_launch")),
])
def test_backward_engine_by_dtype_on_card(dtype, entries, monkeypatch):
    """bf16 dx and dW of the plain conv (#9, #10) and of the BN-input chain
    (#7, #8) launch ``rconv_slab.cu``'s kernels, f32 ones stay on
    ``rconv.cu``'s engine; each wrapper counts one launch either way."""
    _need_card()
    log = []
    lib, slab_lib = rc._lib(), rc._slab_lib()
    monkeypatch.setattr(rc, "_lib", lambda: _Spy(lib, log))
    monkeypatch.setattr(rc, "_slab_lib", lambda: _Spy(slab_lib, log))
    x, w, gy = _inputs(2, 64, 64, 8, 8, dtype, seed=5)
    a, b = _affine(64, seed=6)
    wrappers = (rc.reflect_conv_dx, rc.reflect_conv_dw,
                rc.reflect_conv_dx_bnin, rc.reflect_conv_dw_bnin)
    before = [f.launches for f in wrappers]
    rc.reflect_conv_dx(gy, w, x)
    rc.reflect_conv_dw(x, gy, w)
    rc.reflect_conv_dx_bnin(gy, w, x, a, b)
    rc.reflect_conv_dw_bnin(x, a, b, gy, w)
    torch.cuda.synchronize()
    assert tuple(n for n in log if n.endswith("_launch")) == entries
    assert [f.launches - n for f, n in zip(wrappers, before)] == [1, 1, 1, 1]


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



# ------------------------------------------------- the BN-input chain

BNIN = (rc.reflect_conv_fwd_bnin_stats, rc.reflect_conv_dx_bnin,
        rc.reflect_conv_dw_bnin)
AB_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


def _affine(cin, seed, device="cuda"):
    """a > 0 and b of both signs: about half of relu(a*x + b) is zero."""
    rng = np.random.RandomState(seed)
    a = torch.from_numpy((np.abs(rng.randn(cin)) + 0.5).astype(np.float32))
    b = torch.from_numpy((rng.randn(cin) * 0.5).astype(np.float32))
    return a.to(device), b.to(device)


def _dab_err(da, db, gy, w, x, a, b):
    """The largest per-channel error of da against Σ dxn·g·x and of db
    against Σ dxn·g (f32 sums of the plain f32 dxn), relative to that
    channel's Σ|dxn·g·x| and Σ|dxn·g|."""
    g = rc.bnin_plain(x, a, b)[1]
    with torch.enable_grad():
        xx = torch.zeros_like(x, dtype=torch.float32).requires_grad_()
        dxn, = torch.autograd.grad(rc.reflect_conv_plain(xx, w.float()), xx,
                                   gy.float())
    dxg = dxn * g
    tx = dxg * x.float()
    # a channel gated off everywhere has mass 0 and must give exactly 0
    ea = (da - tx.sum((0, 2, 3))).abs() / tx.abs().sum((0, 2, 3)).clamp_min(1e-30)
    eb = (db - dxg.sum((0, 2, 3))).abs() / dxg.abs().sum((0, 2, 3)).clamp_min(1e-30)
    return float(torch.maximum(ea, eb).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,cin,cout,H,W", [
    (5, 64, 64, 16, 16),         # layer1, N not a multiple of a tile
    (4, 512, 512, 8, 8),         # layer4 interior
    (5, 128, 256, 8, 8),         # Cin != Cout
    (3, 256, 128, 8, 8),         # Cout < Cin
    (2, 64, 64, 32, 32),         # 32x32 maps
    (3, 24, 40, 16, 8),          # channel tails, H != W
    (3, 24, 64, 8, 8),           # a channel tail inside a K chunk, the
                                 # narrow tile, M = 192: a ragged last tile
])
def test_bnin_kernels_match_plain_on_card(N, cin, cout, H, W, dtype):
    _need_card()
    tol = TOL[dtype]
    x, w, gy = _inputs(N, cin, cout, H, W, dtype, seed=cin + cout + H)
    a, b = _affine(cin, seed=cin + H)
    xn, gate = rc.bnin_plain(x, a, b)
    assert 0.2 < float(gate.float().mean()) < 0.8        # a real share gated
    y_ref = rc.reflect_conv_plain(xn, w)
    dx_ref = rc.reflect_conv_dx_bnin_plain(gy, w, x, a, b)[0]
    dw_ref = rc.reflect_conv_plain_bwd(xn, w, gy)[1]
    before = [f.launches for f in BNIN]
    y, s1, s2 = rc.reflect_conv_fwd_bnin_stats(x, a, b, w)
    dx, da, db = rc.reflect_conv_dx_bnin(gy, w, x, a, b)
    dw = rc.reflect_conv_dw_bnin(x, a, b, gy, w)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(BNIN, before)] == [1, 1, 1]
    assert y.dtype == dx.dtype == dw.dtype == dtype
    assert s1.dtype == s2.dtype == da.dtype == db.dtype == torch.float32
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    _close("y", y, y_ref, tol["y"])
    _close("dx", dx, dx_ref, tol["dx"])
    _close("dw", dw, dw_ref, tol["dw"])
    assert _moment_err(s1, s2, y) <= tol["mom"]
    assert _moment_err(s1, s2, y_ref) <= tol["mom_ref"]
    assert _dab_err(da, db, gy, w, x, a, b) <= AB_TOL[dtype]
    # deterministic: no atomics in the moment, da/db or dW reductions
    yb, s1b, s2b = rc.reflect_conv_fwd_bnin_stats(x, a, b, w)
    assert torch.equal(y, yb)
    _, dab, dbb = rc.reflect_conv_dx_bnin(gy, w, x, a, b)
    assert torch.equal(s1, s1b) and torch.equal(s2, s2b)
    assert torch.equal(da, dab) and torch.equal(db, dbb)
    assert torch.equal(dw, rc.reflect_conv_dw_bnin(x, a, b, gy, w))


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W", [(33, 8, 8), (6, 32, 32)])
def test_bnin_backward_repeats_bitwise_on_card(N, H, W):
    """bf16 #7 over many 128-pixel tiles and #8 over many K splits: two runs
    of dx, da, db and dW are bitwise equal (fixed-order sums of the per-tile
    and per-split partials, no float atomics)."""
    _need_card()
    x, w, gy = _inputs(N, 512, 512, H, W, torch.bfloat16, seed=22)
    a, b = _affine(512, seed=23)
    first = (*rc.reflect_conv_dx_bnin(gy, w, x, a, b),
             rc.reflect_conv_dw_bnin(x, a, b, gy, w))
    for _ in range(2):
        again = (*rc.reflect_conv_dx_bnin(gy, w, x, a, b),
                 rc.reflect_conv_dw_bnin(x, a, b, gy, w))
        assert all(torch.equal(p, q) for p, q in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bnin_forward_positive_b_ragged_tile_on_card(dtype):
    """#6 with ``b > 0`` on every channel, so ``relu(b)`` is nonzero
    everywhere, on 3 images of 8x8 (192 pixels: the last tile is ragged):
    its moments match the plain version per channel, so no empty row of
    the ragged tile and no zero-filled operand vector became ``relu(b)``
    (64 such rows would move a channel's sums by ~30%)."""
    _need_card()
    tol = TOL[dtype]
    x, w, _ = _inputs(3, 24, 64, 8, 8, dtype, seed=26)
    a, b = _affine(24, seed=27)
    b = b.abs() + 0.1
    y_ref = rc.reflect_conv_plain(rc.bnin_plain(x, a, b)[0], w)
    y, s1, s2 = rc.reflect_conv_fwd_bnin_stats(x, a, b, w)
    _close("y", y, y_ref, tol["y"])
    assert _moment_err(s1, s2, y) <= tol["mom"]
    assert _moment_err(s1, s2, y_ref) <= tol["mom_ref"]


@pytest.mark.cuda
def test_bnin_dx_corner_legs_and_gate_on_card():
    """Gradients one-hot at the output's corners and edge midpoints: #7
    folds every leg through the pad as the plain version does and gates by
    the raw x at the *input* pixel (f32, exact up to summation order)."""
    _need_card()
    x, w, _ = _inputs(2, 8, 8, 8, 8, torch.float32, seed=3)
    a, b = _affine(8, seed=4)
    gy = torch.zeros((2, 8, 8, 8), device="cuda")
    for h, ww in ((0, 0), (0, 7), (7, 0), (7, 7), (0, 3), (4, 0), (7, 5),
                  (2, 7)):
        gy[:, :, h, ww] = torch.arange(1, 9, device="cuda", dtype=torch.float32)
    gy = gy.contiguous(memory_format=torch.channels_last)
    dx, da, db = rc.reflect_conv_dx_bnin(gy, w, x, a, b)
    dx_ref, da_ref, db_ref = rc.reflect_conv_dx_bnin_plain(gy, w, x, a, b)
    _close("dx", dx, dx_ref, 1e-5)
    _close("da", da, da_ref, 1e-5)
    _close("db", db, db_ref, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bnin_channel_gated_off_on_card(dtype):
    """A ``b`` so negative that channel 3 is gated off everywhere, and one
    so positive that channel 5 is never gated: dx, da, db of channel 3 are
    exactly 0 and its dW rows are 0; channel 5's dx is the plain dx times
    a."""
    _need_card()
    x, w, gy = _inputs(3, 16, 32, 8, 8, dtype, seed=11)
    a, b = _affine(16, seed=12)
    b[3], b[5] = -1e4, 1e4
    dx, da, db = rc.reflect_conv_dx_bnin(gy, w, x, a, b)
    dw = rc.reflect_conv_dw_bnin(x, a, b, gy, w)
    assert not dx[:, 3].any() and da[3] == 0 and db[3] == 0
    assert not dw[:, 3].any()
    plain = rc.reflect_conv_dx(gy, w, x)
    ref5 = rc.reflect_conv_dx_bnin_plain(gy, w, x, a, b)[0][:, 5]
    _close("dx[5]", dx[:, 5], ref5, TOL[dtype]["dx"])
    assert plain[:, 5].abs().max() > 0
    y, s1, s2 = rc.reflect_conv_fwd_bnin_stats(x, a, b, w)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_bnin_op_matches_plain_on_card(dtype):
    """``reflect_conv3x3_bnin_stats`` through autograd with a loss that
    touches y, s1 and s2, against autograd of the plain composition, on an
    NCHW input (the op converts it): gradients for x, a, b and w."""
    _need_card()
    x, w, gy = _inputs(5, 64, 128, 8, 8, dtype, seed=9)
    x = x.contiguous()
    a, b = _affine(64, seed=13)
    rng = np.random.RandomState(10)
    c1 = torch.from_numpy(rng.randn(128).astype(np.float32)).cuda() * 1e-3
    c2 = torch.from_numpy(rng.randn(128).astype(np.float32)).cuda() * 1e-4

    def plain(x, a, b, w):
        pre = x.float() * a[None, :, None, None] + b[None, :, None, None]
        y = rc.reflect_conv_plain(torch.relu(pre).to(x.dtype), w)
        return (y, *rc.moments_plain(y))

    grads = []
    for fn in (rc.reflect_conv3x3_bnin_stats, plain):
        leaves = [t.detach().clone().requires_grad_() for t in (x, a, b, w)]
        y, s1, s2 = fn(*leaves)
        ((y.float() * gy.float()).sum() + (s1 * c1).sum()
         + (s2 * c2).sum()).backward()
        grads.append([t.grad for t in leaves])
    tol = TOL[dtype]
    for name, got, want, rel in zip(
            ("dx", "da", "db", "dw"), grads[0], grads[1],
            (2 * tol["dx"], 2 * tol["dx"], 2 * tol["dx"], 2 * tol["dw"])):
        assert got.dtype == want.dtype
        _close(name, got, want, rel)


@pytest.mark.cuda
def test_bnin_wrappers_refuse_what_the_kernels_do_not_take():
    _need_card()
    x, w, gy = _inputs(2, 64, 64, 8, 8, torch.bfloat16, seed=1)
    a, b = _affine(64, seed=2)
    with pytest.raises(ValueError, match="channels_last"):
        rc.reflect_conv_fwd_bnin_stats(x.contiguous(), a, b, w)
    with pytest.raises(ValueError, match="float32"):
        rc.reflect_conv_fwd_bnin_stats(x, a.bfloat16(), b, w)
    with pytest.raises(ValueError, match=r"\(64,\) float32"):
        rc.reflect_conv_dx_bnin(gy, w, x, a[:32], b)
    with pytest.raises(ValueError, match="float32"):
        rc.reflect_conv_dw_bnin(x, a, b.cpu(), gy, w)
    with pytest.raises(ValueError, match="shape"):
        rc.reflect_conv_dx_bnin(gy, w, x[:1], a, b)
    x12, w12, _ = _inputs(2, 64, 64, 12, 12, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="12x12"):
        rc.reflect_conv_fwd_bnin_stats(x12, a, b, w12)


# ------------------------------- pixel tiles at odd and partial counts

# (N, Cin, Cout, H, W): 128-pixel tiles odd in number, the last one ragged,
# or fewer than one tile
PX_TILE_SHAPES = [
    (5, 64, 64, 8, 8),           # 3 tiles, the last ragged; BN 64
    (9, 128, 256, 8, 16),        # 9 whole tiles; BN 128 both ways
    (5, 512, 512, 8, 8),         # 3 tiles at layer4's width: 32 K chunks
    (1, 24, 40, 8, 8),           # 64 pixels, under one tile; channel tails
    (1, 512, 512, 8, 16),        # exactly one tile
]


def _px_outputs(x, w, gy, a, b):
    """Every pixel-tiled kernel's outputs: #4, #5, #6, #9, #7."""
    return dict(fwd=(rc.reflect_conv_fwd(x, w),),
                fwd_stats=rc.reflect_conv_fwd_stats(x, w),
                fwd_bnin_stats=rc.reflect_conv_fwd_bnin_stats(x, a, b, w),
                dx=(rc.reflect_conv_dx(gy, w, x),),
                dx_bnin=rc.reflect_conv_dx_bnin(gy, w, x, a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("N,cin,cout,H,W", PX_TILE_SHAPES)
def test_px_kernels_at_odd_and_partial_tile_counts_on_card(N, cin, cout, H, W):
    """Each bf16 pixel-tiled mode at an odd number of tiles, a ragged last
    tile, or less than one tile: against the plain version at the
    tolerances above, and #5, #6 and #7 (sums through the per-tile
    partials) bitwise repeatable."""
    _need_card()
    tol = TOL[torch.bfloat16]
    x, w, gy = _inputs(N, cin, cout, H, W, torch.bfloat16, seed=N + cin + W)
    a, b = _affine(cin, seed=cout + H)
    got = _px_outputs(x, w, gy, a, b)
    xn = rc.bnin_plain(x, a, b)[0]
    y_ref = rc.reflect_conv_plain(x, w)
    yb_ref = rc.reflect_conv_plain(xn, w)
    dx_ref = rc.reflect_conv_plain_bwd(x, w, gy)[0]
    dxb_ref = rc.reflect_conv_dx_bnin_plain(gy, w, x, a, b)[0]
    _close("fwd", got["fwd"][0], y_ref, tol["y"])
    _close("fwd_stats", got["fwd_stats"][0], y_ref, tol["y"])
    assert torch.equal(got["fwd"][0], got["fwd_stats"][0])
    _close("fwd_bnin_stats", got["fwd_bnin_stats"][0], yb_ref, tol["y"])
    _close("dx", got["dx"][0], dx_ref, tol["dx"])
    _close("dx_bnin", got["dx_bnin"][0], dxb_ref, tol["dx"])
    for name, ref in (("fwd_stats", y_ref), ("fwd_bnin_stats", yb_ref)):
        y, s1, s2 = got[name]
        assert _moment_err(s1, s2, y) <= tol["mom"], name
        assert _moment_err(s1, s2, ref) <= tol["mom_ref"], name
    assert _dab_err(got["dx_bnin"][1], got["dx_bnin"][2], gy, w, x, a,
                    b) <= AB_TOL[torch.bfloat16]
    for _ in range(2):
        again = _px_outputs(x, w, gy, a, b)
        for name in ("fwd_stats", "fwd_bnin_stats", "dx_bnin"):
            assert all(torch.equal(p, q)
                       for p, q in zip(got[name], again[name])), name
