"""3x3 stride-1 reflect-padded convolution, with the following BatchNorm's
batch moments fused into the forward and, in the BN-input chain, the
preceding BatchNorm's affine and ReLU fused into the operand.

Replaces the Pallas TPU kernels of ``videowalk_tpu/ops/rconv_kernel.py``:
``_fwd_call`` (#4), ``_fwd_call_st`` (#5), ``_fwd_call_bnin_st`` (#6),
``_dx_call_bnin`` (#7), ``_dw_call_bnin`` (#8), ``_dx_call`` (#9) and
``_dw_call`` (#10), with the JAX package's hand VJP:

- ``reflect_conv3x3(x, w)``: ``y = conv_valid(reflect_pad(x, 1), w)``;
  backward dx (#9) and dW (#10).
- ``reflect_conv3x3_stats(x, w) -> (y, s1, s2)``: the same ``y`` plus the
  per-channel f32 sums of the *cast* output, ``s1 = Σ y`` and
  ``s2 = Σ y²`` over N·H·W (#5). Its backward folds the moment cotangents
  into the conv's, ``gy_eff = (gy.f32 + gs1 + 2·y.f32·gs2).to(gy.dtype)``
  on the saved cast ``y``, and reuses dx and dW.
- ``reflect_conv3x3_bnin_stats(x, a, b, w) -> (y, s1, s2)``: the conv and
  moments of ``xn = relu(a·x + b).to(x.dtype)`` (f32 math, per-channel f32
  ``a``, ``b``: the previous BatchNorm's train-mode affine) from the raw
  ``x``; ``xn`` is never written (#6). Backward: the same ``gy_eff``, then
  ``dxn`` = the plain dx of ``gy_eff``, the gate ``g = (a·x + b > 0)``,
  ``dx = (dxn·g·a).to(x.dtype)``, ``da = Σ dxn·g·x`` and ``db = Σ dxn·g``
  per channel from the f32 ``dxn`` (#7), and dW with ``xn`` rebuilt from
  the raw ``x`` (#8). The kernels gate by ``fmaf(x, a, b) > 0``; the plain
  version rounds ``x·a`` before adding ``b``, so an element within one f32
  rounding of 0 may be gated differently.
- dW comes back in the weight's compute dtype (``dw.astype(w9.dtype)``):
  on a bf16 trunk it is rounded to bf16 before the cast to the f32
  parameter.

Layout: the port's trunk is NCHW; the kernels read channel-contiguous
storage, so ``x`` is a ``channels_last`` tensor of logical shape
``(N, Cin, H, W)`` and outputs come back ``channels_last``; weights are
``nn.Conv2d``'s ``(Cout, Cin, 3, 3)``, repacked here to ``(9, Cin, Cout)``
(forward) and ``(9, Cout, Cin)`` (dx).

Each wrapper (``reflect_conv_fwd``, ``reflect_conv_fwd_stats``,
``reflect_conv_dx``, ``reflect_conv_dw``, ``reflect_conv_fwd_bnin_stats``,
``reflect_conv_dx_bnin``, ``reflect_conv_dw_bnin``) takes the plain PyTorch
version
(``F.pad(mode="reflect")`` + ``conv2d`` in the input's dtype, its f32 sums,
and autograd of the same) for a tensor on the CPU, and launches a
hand-written Hopper kernel for a CUDA tensor, or raises:
``csrc/rconv_slab.cu`` (one landed slab of whole image rows feeding all
nine taps, ``wgmma``) for bf16 #5–#10, ``csrc/rconv.cu`` for bf16 #4 and
every f32 kernel. Each counts its kernel launches in ``.launches``.

Bound on the card at the flagship's routed shape (layer4 interior, 3136
images of 8x8, Cin = Cout = 512, bf16): each pass is 0.947 TFLOP, 0.96 ms
at the dense bf16 peak; its ~410 MB of bytes take 0.12 ms. See the
source's note for the design.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F


def rconv_supported(H: int, W: int, kernel: int, stride: int,
                    pad: int) -> bool:
    """Shape gate of the kernels (identical to the JAX package's): 3x3,
    stride 1, pad 1, H and W powers of two in [8, 32]."""
    return (kernel == 3 and stride == 1 and pad == 1
            and 8 <= H <= 32 and 8 <= W <= 32
            and (H & (H - 1)) == 0 and (W & (W - 1)) == 0)


# ----------------------------------------------------------- plain versions


def reflect_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.pad(reflect)`` + valid ``conv2d`` in the input's dtype."""
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w)


def moments_plain(y: torch.Tensor):
    """f32 per-channel ``(Σ y, Σ y²)`` of the (cast) output."""
    yf = y.float()
    return yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))


def reflect_conv_plain_bwd(x: torch.Tensor, w: torch.Tensor,
                           gy: torch.Tensor):
    """Autograd of ``reflect_conv_plain`` at ``gy``: ``(dx, dw)`` in the
    operands' dtypes."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        ww = w.detach().requires_grad_()
        return torch.autograd.grad(reflect_conv_plain(xx, ww), (xx, ww), gy)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.float()[None, :, None, None]


def bnin_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``(xn, g)``: ``xn = relu(a·x + b)`` in f32 cast to x's dtype, and the
    ReLU gate ``g = (a·x + b > 0)``."""
    pre = x.float() * _per_channel(a) + _per_channel(b)
    return torch.relu(pre).to(x.dtype), pre > 0


def reflect_conv_dx_bnin_plain(gy: torch.Tensor, w: torch.Tensor,
                               x: torch.Tensor, a: torch.Tensor,
                               b: torch.Tensor):
    """The JAX VJP's formula: ``dxn`` = the conv's input gradient at ``gy``
    in f32 (the conv is linear in its input), gated, then ``dx =
    (dxn·g·a).to(x.dtype)``, ``da = Σ dxn·g·x``, ``db = Σ dxn·g``."""
    g = bnin_plain(x, a, b)[1]
    with torch.enable_grad():
        xx = torch.zeros_like(x, dtype=torch.float32).requires_grad_()
        dxn, = torch.autograd.grad(reflect_conv_plain(xx, w.float()), xx,
                                   gy.float())
    dxg = dxn * g
    return ((dxg * _per_channel(a)).to(x.dtype),
            (dxg * x.float()).sum((0, 2, 3)), dxg.sum((0, 2, 3)))


# ----------------------------------------------------------------- kernels


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    from videowalk_tpu_torch.ops import _build

    lib = _build.load("rconv")
    if lib.rconv_fwd_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rconv_conv_bm.argtypes = [i]
        lib.rconv_conv_bm.restype = i
        lib.rconv_dw_splits.argtypes = [i] * 6
        lib.rconv_dw_splits.restype = i
        lib.rconv_fwd_launch.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.rconv_fwd_launch.restype = i
        lib.rconv_dx_launch.argtypes = [p] * 3 + [i] * 6 + [p]
        lib.rconv_dx_launch.restype = i
        lib.rconv_dw_launch.argtypes = [p] * 4 + [i] * 7 + [p]
        lib.rconv_dw_launch.restype = i
        lib.rconv_fwd_bnin_launch.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.rconv_fwd_bnin_launch.restype = i
        lib.rconv_dx_bnin_launch.argtypes = [p] * 7 + [i] * 6 + [p]
        lib.rconv_dx_bnin_launch.restype = i
        lib.rconv_dw_bnin_launch.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.rconv_dw_bnin_launch.restype = i
    return lib


def _slab_lib():
    from videowalk_tpu_torch.ops import _build

    lib = _build.load("rconv_slab")
    if lib.rconv_slab_dx_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rconv_slab_bm.argtypes = []
        lib.rconv_slab_bm.restype = i
        lib.rconv_slab_fwd_stats_launch.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.rconv_slab_fwd_stats_launch.restype = i
        lib.rconv_slab_fwd_bnin_stats_launch.argtypes = [p] * 6 + [i] * 5 + [p]
        lib.rconv_slab_fwd_bnin_stats_launch.restype = i
        lib.rconv_slab_dx_launch.argtypes = [p] * 3 + [i] * 5 + [p]
        lib.rconv_slab_dx_launch.restype = i
        lib.rconv_slab_dx_bnin_launch.argtypes = [p] * 7 + [i] * 5 + [p]
        lib.rconv_slab_dx_bnin_launch.restype = i
        lib.rconv_slab_dw_splits.argtypes = [i] * 5
        lib.rconv_slab_dw_splits.restype = i
        lib.rconv_slab_dw_launch.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.rconv_slab_dw_launch.restype = i
        lib.rconv_slab_dw_bnin_launch.argtypes = [p] * 5 + [i] * 6 + [p]
        lib.rconv_slab_dw_bnin_launch.restype = i
    return lib


def _check_act(name: str, tname: str, t: torch.Tensor, dtype: torch.dtype,
               device: torch.device, shape=None) -> None:
    """A CUDA activation the kernels take: bf16 or f32, channels_last
    storage, a supported map, channels a multiple of one 16-byte vector."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in _DTYPES or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: {tname} is {t.dtype} on {t.device}; the "
                         f"kernel takes bf16 or f32, all operands alike, on "
                         f"one device")
    if t.dim() != 4 or (shape is not None and tuple(t.shape) != shape):
        raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}, want "
                         f"{shape or '(N, C, H, W)'}")
    N, C, H, W = t.shape
    if not rconv_supported(H, W, 3, 1, 1):
        raise ValueError(f"{name}: the kernel does not take a {H}x{W} map "
                         f"(rconv_supported: H, W powers of two in [8, 32])")
    vec = 16 // t.element_size()
    if C % vec:
        raise ValueError(f"{name}: {tname} has {C} channels; the kernel needs "
                         f"a multiple of {vec} for {t.dtype}")
    if (not t.is_contiguous(memory_format=torch.channels_last)
            or t.data_ptr() % 16):
        raise ValueError(f"{name}: {tname} must be channels_last "
                         f"(channel-contiguous, 16-byte aligned) storage; got "
                         f"strides {t.stride()}")


def _check_weight(name: str, w: torch.Tensor, x: torch.Tensor,
                  cin: int) -> None:
    if (w.device != x.device or w.dtype != x.dtype or w.dim() != 4
            or tuple(w.shape[1:]) != (cin, 3, 3)):
        raise ValueError(f"{name}: w must be a (Cout, {cin}, 3, 3) {x.dtype} "
                         f"tensor on {x.device}; got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    vec = 16 // x.element_size()
    if w.shape[0] % vec:
        raise ValueError(f"{name}: {w.shape[0]} output channels; the kernel "
                         f"needs a multiple of {vec} for {x.dtype}")


def _pack_ab(name: str, a: torch.Tensor, b: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """The affine as the kernels read it: ``(2, Cin)`` f32 ``[a; b]``."""
    cin = x.shape[1]
    for tname, t in (("a", a), ("b", b)):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (cin,)):
            raise ValueError(f"{name}: {tname} must be a ({cin},) float32 "
                             f"tensor on {x.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return torch.stack((a.detach(), b.detach()))


def _nhwc_empty(N, C, H, W, like):
    return torch.empty((N, C, H, W), dtype=like.dtype, device=like.device,
                       memory_format=torch.channels_last)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd(name: str, x: torch.Tensor, w: torch.Tensor, stats: bool,
         ab=None):
    """Forward #4, with ``stats`` #5, with ``ab = (a, b)`` too #6."""
    _check_act(name, "x", x, x.dtype, x.device)
    N, cin, H, W = x.shape
    _check_weight(name, w, x, cin)
    cout = w.shape[0]
    if ab is not None:
        ab = _pack_ab(name, *ab, x)
    dt = _DTYPES[x.dtype]
    slab = stats and x.dtype == torch.bfloat16   # rconv_slab.cu's #5 / #6
    lib = _slab_lib() if slab else _lib()
    w9 = w.permute(2, 3, 1, 0).reshape(9, cin, cout).contiguous()
    y = _nhwc_empty(N, cout, H, W, x)
    f32 = dict(dtype=torch.float32, device=x.device)
    if stats:
        bm = lib.rconv_slab_bm() if slab else lib.rconv_conv_bm(dt)
        part = torch.empty((-(-N * H * W // int(bm)), 2, cout), **f32)
        s12 = torch.empty((2, cout), **f32)
    else:
        part = s12 = torch.empty((0,), **f32)
    with torch.cuda.device(x.device):
        if slab and ab is None:
            err = lib.rconv_slab_fwd_stats_launch(
                x.data_ptr(), w9.data_ptr(), y.data_ptr(), part.data_ptr(),
                s12.data_ptr(), N, H, W, cin, cout, _stream(x))
        elif slab:
            err = lib.rconv_slab_fwd_bnin_stats_launch(
                x.data_ptr(), ab.data_ptr(), w9.data_ptr(), y.data_ptr(),
                part.data_ptr(), s12.data_ptr(), N, H, W, cin, cout,
                _stream(x))
        elif ab is None:
            err = lib.rconv_fwd_launch(
                x.data_ptr(), w9.data_ptr(), y.data_ptr(), part.data_ptr(),
                s12.data_ptr(), dt, N, H, W, cin, cout, int(stats),
                _stream(x))
        else:
            err = lib.rconv_fwd_bnin_launch(
                x.data_ptr(), ab.data_ptr(), w9.data_ptr(), y.data_ptr(),
                part.data_ptr(), s12.data_ptr(), dt, N, H, W, cin, cout,
                _stream(x))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return (y, s12[0], s12[1]) if stats else y


def reflect_conv_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Forward (#4): ``x (N, Cin, H, W)``, ``w (Cout, Cin, 3, 3)`` ->
    ``y (N, Cout, H, W)`` in x's dtype."""
    if x.device.type == "cpu":
        return reflect_conv_plain(x, w)
    y = _fwd("reflect_conv_fwd", x, w, stats=False)
    reflect_conv_fwd.launches += 1
    return y


reflect_conv_fwd.launches = 0


def reflect_conv_fwd_stats(x: torch.Tensor, w: torch.Tensor):
    """Forward with moments (#5): ``(y, s1, s2)``, ``s1``/``s2`` f32
    ``(Cout,)`` sums of the cast ``y`` and ``y²`` over N·H·W."""
    if x.device.type == "cpu":
        y = reflect_conv_plain(x, w)
        return (y, *moments_plain(y))
    out = _fwd("reflect_conv_fwd_stats", x, w, stats=True)
    reflect_conv_fwd_stats.launches += 1
    return out


reflect_conv_fwd_stats.launches = 0


def reflect_conv_fwd_bnin_stats(x: torch.Tensor, a: torch.Tensor,
                                b: torch.Tensor, w: torch.Tensor):
    """Forward of the BN-input chain (#6): ``(y, s1, s2)`` of the conv of
    ``xn = relu(a·x + b).to(x.dtype)`` from the raw ``x (N, Cin, H, W)``
    and the f32 ``a``, ``b (Cin,)``; the kernel never writes ``xn``."""
    if x.device.type == "cpu":
        y = reflect_conv_plain(bnin_plain(x, a, b)[0], w)
        return (y, *moments_plain(y))
    out = _fwd("reflect_conv_fwd_bnin_stats", x, w, stats=True, ab=(a, b))
    reflect_conv_fwd_bnin_stats.launches += 1
    return out


reflect_conv_fwd_bnin_stats.launches = 0


def _dx(name: str, gy: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
        ab=None):
    """Input gradient #9; with ``ab = (a, b)`` #7: ``(dx, da, db)``."""
    _check_act(name, "gy", gy, w.dtype, w.device)
    N, cout, H, W = gy.shape
    cin = w.shape[1]
    _check_act(name, "x", x, w.dtype, w.device, (N, cin, H, W))
    _check_weight(name, w, gy, cin)
    if w.shape[0] != cout:
        raise ValueError(f"{name}: gy has {cout} channels, w {w.shape[0]}")
    if ab is not None:
        ab = _pack_ab(name, *ab, x)
    dt = _DTYPES[gy.dtype]
    slab = gy.dtype == torch.bfloat16     # rconv_slab.cu's #9 / #7
    lib = _slab_lib() if slab else _lib()
    w9t = w.permute(2, 3, 0, 1).reshape(9, cout, cin).contiguous()
    dx = _nhwc_empty(N, cin, H, W, gy)
    if ab is not None:
        f32 = dict(dtype=torch.float32, device=gy.device)
        bm = lib.rconv_slab_bm() if slab else lib.rconv_conv_bm(dt)
        part = torch.empty((-(-N * H * W // int(bm)), 2, cin), **f32)
        dab = torch.empty((2, cin), **f32)
    with torch.cuda.device(gy.device):
        if ab is None and slab:
            err = lib.rconv_slab_dx_launch(
                gy.data_ptr(), w9t.data_ptr(), dx.data_ptr(), N, H, W, cin,
                cout, _stream(gy))
        elif ab is None:
            err = lib.rconv_dx_launch(gy.data_ptr(), w9t.data_ptr(),
                                      dx.data_ptr(), dt, N, H, W, cin, cout,
                                      _stream(gy))
        elif slab:
            err = lib.rconv_slab_dx_bnin_launch(
                gy.data_ptr(), w9t.data_ptr(), x.data_ptr(), ab.data_ptr(),
                dx.data_ptr(), part.data_ptr(), dab.data_ptr(), N, H, W, cin,
                cout, _stream(gy))
        else:
            err = lib.rconv_dx_bnin_launch(
                gy.data_ptr(), w9t.data_ptr(), x.data_ptr(), ab.data_ptr(),
                dx.data_ptr(), part.data_ptr(), dab.data_ptr(), dt, N, H, W,
                cin, cout, _stream(gy))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return dx if ab is None else (dx, dab[0], dab[1])


def reflect_conv_dx(gy: torch.Tensor, w: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Input gradient (#9) of the conv at ``gy (N, Cout, H, W)``; ``x``
    only for its shape on the CPU path (the plain version differentiates
    the conv at it)."""
    if gy.device.type == "cpu":
        return reflect_conv_plain_bwd(x, w, gy)[0]
    dx = _dx("reflect_conv_dx", gy, w, x)
    reflect_conv_dx.launches += 1
    return dx


reflect_conv_dx.launches = 0


def reflect_conv_dx_bnin(gy: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                         a: torch.Tensor, b: torch.Tensor):
    """Input gradient of the BN-input chain (#7) at ``gy (N, Cout, H, W)``
    and the raw ``x``: ``(dx, da, db)`` with ``dx`` in x's dtype and the
    f32 per-channel ``da = Σ dxn·g·x``, ``db = Σ dxn·g``."""
    if gy.device.type == "cpu":
        return reflect_conv_dx_bnin_plain(gy, w, x, a, b)
    out = _dx("reflect_conv_dx_bnin", gy, w, x, ab=(a, b))
    reflect_conv_dx_bnin.launches += 1
    return out


reflect_conv_dx_bnin.launches = 0


def _dw(name: str, x: torch.Tensor, gy: torch.Tensor, w: torch.Tensor,
        ab=None) -> torch.Tensor:
    """Weight gradient #10; with ``ab = (a, b)`` #8 (of ``xn``)."""
    _check_act(name, "x", x, x.dtype, x.device)
    N, cin, H, W = x.shape
    _check_weight(name, w, x, cin)
    cout = w.shape[0]
    _check_act(name, "gy", gy, x.dtype, x.device, (N, cout, H, W))
    if ab is not None:
        ab = _pack_ab(name, *ab, x)
    dt = _DTYPES[x.dtype]
    slab = x.dtype == torch.bfloat16      # rconv_slab.cu's #10 / #8
    lib = _slab_lib() if slab else _lib()
    splits = int(lib.rconv_slab_dw_splits(N, H, W, cin, cout) if slab
                 else lib.rconv_dw_splits(dt, N, H, W, cin, cout))
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((splits, 9, cin, cout), **f32)
    dw9 = torch.empty((9, cin, cout), **f32)
    with torch.cuda.device(x.device):
        if ab is None and slab:
            err = lib.rconv_slab_dw_launch(
                x.data_ptr(), gy.data_ptr(), part.data_ptr(), dw9.data_ptr(),
                N, H, W, cin, cout, splits, _stream(x))
        elif slab:
            err = lib.rconv_slab_dw_bnin_launch(
                x.data_ptr(), ab.data_ptr(), gy.data_ptr(), part.data_ptr(),
                dw9.data_ptr(), N, H, W, cin, cout, splits, _stream(x))
        elif ab is None:
            err = lib.rconv_dw_launch(x.data_ptr(), gy.data_ptr(),
                                      part.data_ptr(), dw9.data_ptr(), dt, N,
                                      H, W, cin, cout, splits, _stream(x))
        else:
            err = lib.rconv_dw_bnin_launch(
                x.data_ptr(), ab.data_ptr(), gy.data_ptr(), part.data_ptr(),
                dw9.data_ptr(), dt, N, H, W, cin, cout, splits, _stream(x))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return dw9.to(w.dtype).reshape(3, 3, cin, cout).permute(3, 2, 0, 1)


def reflect_conv_dw(x: torch.Tensor, gy: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Weight gradient (#10): ``(Cout, Cin, 3, 3)`` in ``w``'s (the compute)
    dtype, summed in f32; ``w`` only for its shape and dtype."""
    if x.device.type == "cpu":
        return reflect_conv_plain_bwd(x, w, gy)[1]
    dw = _dw("reflect_conv_dw", x, gy, w)
    reflect_conv_dw.launches += 1
    return dw


reflect_conv_dw.launches = 0


def reflect_conv_dw_bnin(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         gy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the BN-input chain (#8): dW of the conv of
    ``xn = relu(a·x + b).to(x.dtype)`` at ``gy``, from the raw ``x``."""
    if x.device.type == "cpu":
        return reflect_conv_plain_bwd(bnin_plain(x, a, b)[0], w, gy)[1]
    dw = _dw("reflect_conv_dw_bnin", x, gy, w, ab=(a, b))
    reflect_conv_dw_bnin.launches += 1
    return dw


reflect_conv_dw_bnin.launches = 0


# ------------------------------------------------------------ autograd ops


def _as_kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """CUDA tensors go to the kernels in channels_last storage (a no-op
    when they are already); CPU tensors take the plain versions as they
    are."""
    if t.device.type == "cuda":
        return t.contiguous(memory_format=torch.channels_last)
    return t


def _fold_moment_cotangents(gy, gs1, gs2, y):
    """The moments' cotangents folded into the conv's, on the saved cast
    ``y``: ``(gy.f32 + gs1 + 2·y.f32·gs2).to(y.dtype)``."""
    return (gy.float() + gs1[None, :, None, None]
            + 2.0 * y.float() * gs2[None, :, None, None]).to(y.dtype)


class _ReflectConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stats):
        x = _as_kernel_layout(x)
        if stats:
            y, s1, s2 = reflect_conv_fwd_stats(x, w)
            ctx.save_for_backward(x, w, y)
            ctx.stats = True
            return y, s1, s2
        y = reflect_conv_fwd(x, w)
        ctx.save_for_backward(x, w)
        ctx.stats = False
        return y

    @staticmethod
    def backward(ctx, gy, gs1=None, gs2=None):
        if ctx.stats:
            x, w, y = ctx.saved_tensors
            gy = _fold_moment_cotangents(gy, gs1, gs2, y)
        else:
            x, w = ctx.saved_tensors
        gy = _as_kernel_layout(gy)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = reflect_conv_dx(gy, w, x)
        if ctx.needs_input_grad[1]:
            dw = reflect_conv_dw(x, gy, w)
        return dx, dw, None


def reflect_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = conv_valid(reflect_pad(x, 1), w)``, 3x3 stride 1: ``x (N, Cin,
    H, W)`` and ``w (Cout, Cin, 3, 3)`` in one compute dtype (bf16 or f32 on
    the card) -> ``y (N, Cout, H, W)`` in that dtype, f32 accumulation."""
    return _ReflectConv.apply(x, w, False)


def reflect_conv3x3_stats(x: torch.Tensor, w: torch.Tensor):
    """:func:`reflect_conv3x3` plus the following BatchNorm's moments
    ``(y, s1, s2)``: ``s1 = Σ y``, ``s2 = Σ y²`` per channel over N·H·W, in
    f32, of the cast ``y``."""
    return _ReflectConv.apply(x, w, True)


class _ReflectConvBnin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, w):
        x = _as_kernel_layout(x)
        y, s1, s2 = reflect_conv_fwd_bnin_stats(x, a, b, w)
        ctx.save_for_backward(x, a, b, w, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, a, b, w, y = ctx.saved_tensors
        gy = _as_kernel_layout(_fold_moment_cotangents(gy, gs1, gs2, y))
        dx = da = db = dw = None
        if any(ctx.needs_input_grad[:3]):
            dx, da, db = reflect_conv_dx_bnin(gy, w, x, a, b)
            da, db = da.to(a.dtype), db.to(b.dtype)
        if ctx.needs_input_grad[3]:
            dw = reflect_conv_dw_bnin(x, a, b, gy, w)
        return dx, da, db, dw


def reflect_conv3x3_bnin_stats(x: torch.Tensor, a: torch.Tensor,
                               b: torch.Tensor, w: torch.Tensor):
    """:func:`reflect_conv3x3_stats` of ``relu(a·x + b)``: ``x`` is the
    previous conv's raw output, ``a``, ``b (Cin,)`` f32 its train-mode
    BatchNorm's affine (``models/resnet.py::BatchNorm.fold_affine``); the
    normalized activation is never written. ``(y, s1, s2)`` with the
    moments for the following BatchNorm; gradients flow to x, a, b and w."""
    return _ReflectConvBnin.apply(x, a, b, w)
