"""Train-mode BatchNorm with its residual add and ReLU, on hand-written
kernels: the moments, one normalize + add + ReLU pass, and a backward of
one reduce pass and one apply pass.

Replaces no TPU kernel: the JAX package leaves BN's passes to XLA, which
fuses them. The port ran them as an eager chain: a cast to f32, the
moments, ``(y - mean)·mul + bias``, the cast back, the add, the ReLU, and
autograd's replay of each in f32 (about 46 bytes an element forward and
100 backward). The kernels (``csrc/bn_act.cu``) move 4-6 forward and 14-20
backward.

``bn_act(y, bn, moments, shortcut=, proj=, relu=)`` is one train-mode
``BatchNorm`` (``models/resnet.py``; ``bn`` gives its weight, bias, eps,
momentum, running statistics, compute dtype and ``group``) of ``y``, with
what follows it in a block:

    out = relu(T(T(BN(y)) + r))

``r`` the identity shortcut ``shortcut``, or ``T(BN_d(yd))`` of the
projection ``proj = (yd, bn_d)``, or absent; the ReLU where ``relu``; ``T``
the BN's dtype. BN(y) is flax's ``(y - mean)·(rsqrt(var + eps)·weight) +
bias`` in f32 from the batch moments (``moments = (Σy, Σy²)`` from the
conv's epilogue, else reduced here; with a ``group``, averaged over it),
and the running statistics move unless ``update`` is False (a
rematerialized block's recompute). ``bn_affine(y, bn, moments)`` is the
BN reduced to its per-channel affine ``(a, b)`` for the BN-input chain
(``ops/rconv.py::reflect_conv3x3_bnin_stats``).

Each takes the eager chain (``bn_act_plain``, ``bn_affine_plain``: the
port's BN before these kernels, unchanged, so the CPU tests against the JAX
package hold) for a tensor on the CPU, and the kernels' autograd functions
(``bn_act_fused``, ``bn_affine_fused``) for a CUDA tensor:

- forward: the moments where the conv gave none (``bn_moments``, one read),
  the per-channel arithmetic in PyTorch on (C,) vectors (the one all-reduce
  of ``(E[y], E[y²])`` with a group, the running statistics), then
  ``bn_act_fwd`` writes ``out``;
- backward: ``bn_act_reduce_bwd`` gives per channel ``Σg``, ``Σg·(y −
  mean)`` (and ``Σg·(yd − mean_d)``), ``g`` the ReLU-gated gradient, and
  writes ``dr = g`` for an identity shortcut; the per-channel cotangents
  follow in PyTorch (through the group's all-reduce, as
  ``parallel/mesh.py::all_reduce_sum``'s backward); ``bn_act_apply_bwd``
  writes ``dy = T(g·mul + gs1 + 2·y·gs2)`` (and ``dyd``), the moments'
  cotangents ``gs1``, ``gs2`` folded in, so a conv that emitted the
  moments gets none back (``ops/rconv.py`` skips its fold);
- ``bn_affine_fused``'s moments come from the conv, whose backward folds
  their cotangents (``bn_fold``), or from ``bn_moments`` through an
  autograd function that returns ``y`` and folds them the same way.

Nothing in f32 is written at activation size. Each pass wrapper
(``bn_moments``, ``bn_act_fwd``, ``bn_act_reduce_bwd``,
``bn_act_apply_bwd``, ``bn_fold``) takes its plain PyTorch version for a
CPU tensor (the same arithmetic; the CPU tests run the autograd functions
on them) and launches its kernel for a CUDA one, or raises, and counts its
kernel launches in ``.launches``. The kernels take bf16 and f32 in
channels_last or NCHW storage, each operand in its own (the first block
after an NCHW stem adds an NCHW shortcut to a channels_last y).

``bn_act`` and ``bn_affine`` add ``bn_fused`` (the kernels) or ``bn_plain``
(the eager chain) to the innermost open span (``utils/profile.py::count``,
the ``trunk`` span in the model): one a BN forward and one for its
backward, counted when the forward runs with a gradient to come (not again
for a recompute, whose backward is the first forward's).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from videowalk_tpu_torch.utils import profile

PLAIN, IDENTITY, PROJ = 0, 1, 2          # csrc/bn_act.cu's modes


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or in its own type where that is wider (an f64 model on
    the CPU keeps f64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _count(fused: bool, n_bn: int, update: bool, tensors) -> None:
    """``n_bn`` BN forwards, and their backwards where a gradient is to
    come and this is not a recompute (``update`` False), into the innermost
    open span."""
    if not profile.on():
        return
    grad = update and torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
    profile.count(**{"bn_fused" if fused else "bn_plain":
                     n_bn * (2 if grad else 1)})


# ---------------------------------------------------- the eager chain (CPU)


def batch_stats(bn, x: torch.Tensor, xf: torch.Tensor | None, moments,
                update: bool = True):
    """Train mode: the batch ``(mean, var)`` in f32, from ``moments`` or a
    reduce over ``xf``, and the running statistics updated unless
    ``update`` is False.

    With a ``group`` attached (``parallel/mesh.py::attach_group``), each
    rank's ``(E[y], E[y²])`` are averaged over the group by one
    differentiable all-reduce, so they are the global batch's: the ranks
    hold equal row blocks (the global batch splits evenly), so the global
    count is the group size times the local one. At a group of one this is
    bitwise the ungrouped path. The all-reduce also runs on a
    rematerialized block's recompute, on every rank alike."""
    if moments is None:
        mean = xf.mean(dim=(0, 2, 3))
        ex2 = (xf * xf).mean(dim=(0, 2, 3))
    else:
        count = x.numel() // x.shape[1]
        mean, ex2 = moments[0] / count, moments[1] / count
    mean, ex2 = _group_mean(bn, mean, ex2)
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    if update:
        _update_running(bn, mean, var)
    return mean, var


def _group_mean(bn, mean: torch.Tensor, ex2: torch.Tensor):
    """``(E[y], E[y²])`` averaged over ``bn.group`` by one differentiable
    all-reduce where one is attached, else as they are."""
    if bn.group is None:
        return mean, ex2
    from videowalk_tpu_torch.parallel.mesh import all_reduce_sum, group_size

    packed = all_reduce_sum(torch.cat([mean, ex2]), bn.group)
    return (packed / group_size(bn.group)).chunk(2)


def _update_running(bn, mean: torch.Tensor, var: torch.Tensor) -> None:
    with torch.no_grad():
        bn.running_mean.mul_(1 - bn.momentum).add_(mean.detach(),
                                                   alpha=bn.momentum)
        bn.running_var.mul_(1 - bn.momentum).add_(var.detach(),
                                                  alpha=bn.momentum)
        bn.num_batches_tracked.add_(1)


def _bn_plain(x: torch.Tensor, bn, moments, update: bool) -> torch.Tensor:
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean, var = batch_stats(bn, x, xf, moments, update)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] \
        + bn.bias[:, None, None]
    return y.to(bn.dtype)


def bn_act_plain(y: torch.Tensor, bn, moments=None, *, shortcut=None,
                 proj=None, relu: bool = False,
                 update: bool = True) -> torch.Tensor:
    """The eager chain: ``bn_act``'s result by autograd."""
    z = _bn_plain(y, bn, moments, update)
    if proj is not None:
        shortcut = _bn_plain(proj[0], proj[1], None, update)
    if shortcut is not None:
        z = z + shortcut
    return F.relu(z) if relu else z


def bn_affine_plain(y: torch.Tensor, bn, moments=None, *,
                    update: bool = True):
    """The eager ``(a, b)``: ``a = rsqrt(var + eps)·weight``, ``b = bias −
    mean·a``."""
    xf = (None if moments is not None
          else y.to(torch.promote_types(y.dtype, torch.float32)))
    mean, var = batch_stats(bn, y, xf, moments, update)
    a = torch.rsqrt(var + bn.eps) * bn.weight
    return a, bn.bias - mean * a


def fold_plain(gy: torch.Tensor, gs1: torch.Tensor, gs2: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """The moments' cotangents folded into ``y``'s:
    ``(gy.f32 + gs1 + 2·y.f32·gs2).to(y.dtype)``."""
    return (_wide(gy) + gs1[None, :, None, None]
            + 2.0 * _wide(y) * gs2[None, :, None, None]).to(y.dtype)


# ------------------------------------------- the passes' plain versions


def _pc(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def _normalize(x: torch.Tensor, mean, mul, bias) -> torch.Tensor:
    return ((_wide(x) - _pc(mean)) * _pc(mul) + _pc(bias)).to(x.dtype)


def moments_plain(y: torch.Tensor):
    yf = _wide(y)
    return yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))


def act_fwd_plain(y, prm, sc, mode: int, relu: bool) -> torch.Tensor:
    z = _normalize(y, *prm[:3])
    if mode == PROJ:
        sc = _normalize(sc, *prm[3:])
    if mode != PLAIN:
        z = z + sc
    return torch.relu(z) if relu else z


def _gated(go, out, relu: bool) -> torch.Tensor:
    g = _wide(go)
    return torch.where(out > 0, g, torch.zeros_like(g)) if relu else g


def act_reduce_bwd_plain(go, out, y, yd, prm, mode: int, relu: bool):
    g = _gated(go, out, relu)
    sums = [g.sum((0, 2, 3)), (g * (_wide(y) - _pc(prm[0]))).sum((0, 2, 3))]
    if mode == PROJ:
        sums.append((g * (_wide(yd) - _pc(prm[1]))).sum((0, 2, 3)))
    return torch.stack(sums), g.to(go.dtype) if mode == IDENTITY else None


def act_apply_bwd_plain(go, out, y, yd, prm, mode: int, relu: bool):
    g = _gated(go, out, relu)

    def grad(x, mul, gs1, gs2):
        return (g * _pc(mul) + _pc(gs1) + 2.0 * _wide(x) * _pc(gs2)).to(x.dtype)

    return (grad(y, *prm[:3]),
            grad(yd, *prm[3:]) if mode == PROJ else None)


# --------------------------------------------------------------- kernels


def _lib():
    from videowalk_tpu_torch.ops import _build

    lib = _build.load("bn_act")
    if lib.bn_moments_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        geo = [ll, i, ll]
        lib.bn_act_max_splits.argtypes = []
        lib.bn_act_max_splits.restype = i
        lib.bn_act_takes.argtypes = geo + [i, i]
        lib.bn_act_takes.restype = i
        lib.bn_moments_launch.argtypes = [p] * 3 + geo + [i, i, p]
        lib.bn_moments_launch.restype = i
        lib.bn_act_fwd_launch.argtypes = [p] * 4 + geo + [i] * 5 + [p]
        lib.bn_act_fwd_launch.restype = i
        lib.bn_act_reduce_bwd_launch.argtypes = ([p] * 8 + geo + [i] * 5
                                                 + [p])
        lib.bn_act_reduce_bwd_launch.restype = i
        lib.bn_act_apply_bwd_launch.argtypes = [p] * 7 + geo + [i] * 5 + [p]
        lib.bn_act_apply_bwd_launch.restype = i
        lib.bn_fold_launch.argtypes = [p] * 4 + geo + [i, i, p]
        lib.bn_fold_launch.restype = i
    return lib


_DTYPES = (torch.float32, torch.bfloat16)


def _nchw(name: str, tname: str, t: torch.Tensor) -> int:
    """1 for NCHW storage, 0 for channels_last; raises on any other."""
    if t.is_contiguous():
        return 1
    if t.is_contiguous(memory_format=torch.channels_last):
        return 0
    raise ValueError(f"{name}: {tname} must be NCHW or channels_last "
                     f"storage; got strides {t.stride()}")


def _in_layout(t: torch.Tensor, nchw: int) -> torch.Tensor:
    """``t`` in NCHW (``nchw``) or channels_last storage, a copy where it
    is in another."""
    return t.contiguous(memory_format=torch.contiguous_format if nchw
                        else torch.channels_last)


def _check(name: str, y: torch.Tensor, **others) -> tuple:
    """A CUDA activation the kernels take, and operands like it: ``(N, C,
    H·W, nchw)`` of y."""
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    if y.dtype not in _DTYPES or y.dim() != 4:
        raise ValueError(f"{name}: y is a {y.dim()}-d {y.dtype} tensor; the "
                         f"kernels take 4-d bf16 or f32")
    for tname, t in others.items():
        if t is not None and (t.device != y.device or t.dtype != y.dtype
                              or t.shape != y.shape):
            raise ValueError(f"{name}: {tname} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; want y's "
                             f"{y.dtype} {tuple(y.shape)} on {y.device}")
    N, C, H, W = y.shape
    nchw = _nchw(name, "y", y)
    if not _lib().bn_act_takes(N, C, H * W, nchw, int(y.dtype == torch.bfloat16)):
        raise ValueError(f"{name}: the kernels do not take {C} channels in "
                         f"channels_last storage (at most 2048, a multiple "
                         f"of 16 bytes past 512)")
    return N, C, H * W, nchw


def _params(name: str, prm: torch.Tensor, rows: int, C: int,
            device) -> torch.Tensor:
    if (prm.device != device or prm.dtype != torch.float32
            or tuple(prm.shape) != (rows, C)):
        raise ValueError(f"{name}: per-channel parameters must be a "
                         f"({rows}, {C}) float32 tensor on {device}; got "
                         f"{prm.dtype} {tuple(prm.shape)} on {prm.device}")
    return prm.contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _part(lib, k: int, C: int, device) -> torch.Tensor:
    return torch.empty((int(lib.bn_act_max_splits()) * k * C,),
                       dtype=torch.float32, device=device)


def bn_moments(y: torch.Tensor):
    """Per-channel ``(Σ y, Σ y²)`` of ``y (N, C, H, W)`` over N·H·W, in f32
    (``bn_moments_reduce`` + ``bn_partials_reduce``)."""
    if y.device.type == "cpu":
        return moments_plain(y)
    N, C, HW, nchw = _check("bn_moments", y)
    lib = _lib()
    sums = torch.empty((2, C), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        err = lib.bn_moments_launch(
            y.data_ptr(), _part(lib, 2, C, y.device).data_ptr(),
            sums.data_ptr(), N, C, HW, nchw, int(y.dtype == torch.bfloat16),
            _stream(y))
    _launched("bn_moments", err)
    bn_moments.launches += 1
    return sums[0], sums[1]


bn_moments.launches = 0


def bn_act_fwd(y: torch.Tensor, prm: torch.Tensor, sc: torch.Tensor | None,
               mode: int, relu: bool) -> torch.Tensor:
    """``out = relu(T(T(BN(y)) + r))`` (``bn_act_elementwise_fwd``):
    ``prm`` f32 ``(3, C)`` mean, mul, bias of y (``(6, C)`` with the
    projection's after them, ``mode`` PROJ, ``sc = yd``); ``sc`` the
    identity shortcut (IDENTITY) or None (PLAIN). ``out`` in y's layout."""
    if y.device.type == "cpu":
        return act_fwd_plain(y, prm, sc, mode, relu)
    N, C, HW, nchw = _check("bn_act_fwd", y, sc=sc)
    prm = _params("bn_act_fwd", prm, 6 if mode == PROJ else 3, C, y.device)
    out = torch.empty_like(y)
    sc_nchw = nchw if sc is None else _nchw("bn_act_fwd", "sc", sc)
    with torch.cuda.device(y.device):
        err = _lib().bn_act_fwd_launch(
            y.data_ptr(), 0 if sc is None else sc.data_ptr(), out.data_ptr(),
            prm.data_ptr(), N, C, HW, nchw, sc_nchw, mode, int(relu),
            int(y.dtype == torch.bfloat16), _stream(y))
    _launched("bn_act_fwd", err)
    bn_act_fwd.launches += 1
    return out


bn_act_fwd.launches = 0


def bn_act_reduce_bwd(go: torch.Tensor, out: torch.Tensor, y: torch.Tensor,
                      yd: torch.Tensor | None, prm: torch.Tensor, mode: int,
                      relu: bool):
    """The backward's reduce pass (``bn_act_reduce_bwd`` +
    ``bn_partials_reduce``): ``(sums, dr)`` with f32 ``sums`` ``(2, C)``
    ``Σg``, ``Σg·(y − mean)`` (``(3, C)``, ``Σg·(yd − mean_d)`` third, with
    a projection), ``g`` = ``go`` where ``out > 0`` (``go`` without the
    ReLU), and ``dr = g`` in y's type and layout for an identity shortcut
    (else None). ``prm``: f32 mean ``(1, C)`` (and mean_d, ``(2, C)``).
    ``go`` and ``out`` in y's layout."""
    if y.device.type == "cpu":
        return act_reduce_bwd_plain(go, out, y, yd, prm, mode, relu)
    N, C, HW, nchw = _check("bn_act_reduce_bwd", y, go=go, out=out, yd=yd)
    for tname, t in (("go", go), ("out", out)):
        if _nchw("bn_act_reduce_bwd", tname, t) != nchw:
            raise ValueError(f"bn_act_reduce_bwd: {tname} is not in y's "
                             f"layout")
    k = 3 if mode == PROJ else 2
    prm = _params("bn_act_reduce_bwd", prm, k - 1, C, y.device)
    lib = _lib()
    sums = torch.empty((k, C), dtype=torch.float32, device=y.device)
    dr = torch.empty_like(y) if mode == IDENTITY else None
    sc_nchw = nchw if yd is None else _nchw("bn_act_reduce_bwd", "yd", yd)
    with torch.cuda.device(y.device):
        err = lib.bn_act_reduce_bwd_launch(
            go.data_ptr(), out.data_ptr(), y.data_ptr(),
            0 if yd is None else yd.data_ptr(),
            0 if dr is None else dr.data_ptr(), prm.data_ptr(),
            _part(lib, k, C, y.device).data_ptr(), sums.data_ptr(), N, C, HW,
            nchw, sc_nchw, mode, int(relu), int(y.dtype == torch.bfloat16),
            _stream(y))
    _launched("bn_act_reduce_bwd", err)
    bn_act_reduce_bwd.launches += 1
    return sums, dr


bn_act_reduce_bwd.launches = 0


def bn_act_apply_bwd(go: torch.Tensor, out: torch.Tensor, y: torch.Tensor,
                     yd: torch.Tensor | None, prm: torch.Tensor, mode: int,
                     relu: bool):
    """The backward's apply pass (``bn_act_elementwise_bwd``): ``(dy,
    dyd)``, ``dy = T(g·mul + gs1 + 2·y·gs2)`` in y's layout and, with the
    projection (``mode`` PROJ), ``dyd`` likewise in yd's (else None).
    ``prm``: f32 ``(3, C)`` mul, gs1, gs2 (``(6, C)`` with the
    projection's). ``mode`` is PLAIN or PROJ: an identity shortcut's
    backward passes its ``dr`` as ``go``, without the ReLU."""
    if y.device.type == "cpu":
        return act_apply_bwd_plain(go, out, y, yd, prm, mode, relu)
    if mode not in (PLAIN, PROJ):
        raise ValueError(f"bn_act_apply_bwd: mode {mode}: want PLAIN or PROJ")
    N, C, HW, nchw = _check("bn_act_apply_bwd", y, go=go, out=out, yd=yd)
    for tname, t in (("go", go), ("out", out)):
        if _nchw("bn_act_apply_bwd", tname, t) != nchw:
            raise ValueError(f"bn_act_apply_bwd: {tname} is not in y's "
                             f"layout")
    prm = _params("bn_act_apply_bwd", prm, 6 if mode == PROJ else 3, C,
                  y.device)
    dy = torch.empty_like(y)
    dyd = torch.empty_like(yd) if mode == PROJ else None
    sc_nchw = nchw if yd is None else _nchw("bn_act_apply_bwd", "yd", yd)
    with torch.cuda.device(y.device):
        err = _lib().bn_act_apply_bwd_launch(
            go.data_ptr(), out.data_ptr(), y.data_ptr(),
            0 if yd is None else yd.data_ptr(), dy.data_ptr(),
            0 if dyd is None else dyd.data_ptr(), prm.data_ptr(), N, C, HW,
            nchw, sc_nchw, mode, int(relu), int(y.dtype == torch.bfloat16),
            _stream(y))
    _launched("bn_act_apply_bwd", err)
    bn_act_apply_bwd.launches += 1
    return dy, dyd


bn_act_apply_bwd.launches = 0


def bn_fold(gy: torch.Tensor, gs1: torch.Tensor | None,
            gs2: torch.Tensor | None, y: torch.Tensor) -> torch.Tensor:
    """``fold_plain`` (``bn_fold_elementwise``): the cotangents of ``y``'s
    moments ``(Σy, Σy²)`` folded into its gradient ``gy``, in y's layout; a
    cotangent that is None counts as 0, both None leave ``gy``."""
    if gs1 is None and gs2 is None:
        return gy
    C = y.shape[1]
    zero = torch.zeros((C,), device=y.device,
                       dtype=torch.promote_types(y.dtype, torch.float32))
    gs1 = zero if gs1 is None else gs1
    gs2 = zero if gs2 is None else gs2
    if y.device.type == "cpu":
        return fold_plain(gy, gs1, gs2, y)
    N, C, HW, nchw = _check("bn_fold", y, gy=gy)
    gy = _in_layout(gy, nchw)
    prm = _params("bn_fold", torch.stack((gs1, gs2)).float(), 2, C, y.device)
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        err = _lib().bn_fold_launch(
            gy.data_ptr(), y.data_ptr(), out.data_ptr(), prm.data_ptr(), N, C,
            HW, nchw, int(y.dtype == torch.bfloat16), _stream(y))
    _launched("bn_fold", err)
    bn_fold.launches += 1
    return out


bn_fold.launches = 0


# ---------------------------------------------------- autograd functions


def _affine(bn, mean: torch.Tensor, ex2: torch.Tensor):
    """``(var, inv, mul)``: the biased variance, ``rsqrt(var + eps)`` and
    ``mul = inv·weight``."""
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    inv = torch.rsqrt(var + bn.eps)
    return var, inv, inv * bn.weight.detach()


def _forward_side(bn, y: torch.Tensor, moments, update: bool):
    """One BN's forward arithmetic on (C,) vectors: ``(mean, ex2, prm)``,
    ``prm = [mean, mul, bias]``; the running statistics move where
    ``update``."""
    s1, s2 = moments if moments is not None else bn_moments(y)
    count = y.numel() // y.shape[1]
    mean, ex2 = _group_mean(bn, s1 / count, s2 / count)
    var, _, mul = _affine(bn, mean, ex2)
    if update:
        _update_running(bn, mean, var)
    return mean, ex2, [mean, mul, bn.bias.detach()]


def _backward_side(bn, mean, ex2, sum_g, sum_gy, count: int):
    """One BN's per-channel cotangents from the reduce pass's ``Σg`` and
    ``Σg·(y − mean)``: ``(prm, dweight, dbias)``, ``prm = [mul, gs1,
    gs2]`` with ``gs1``, ``gs2`` the cotangents of the local ``Σy``,
    ``Σy²`` (the group's all-reduce between)."""
    var, inv, mul = _affine(bn, mean, ex2)
    dvar = sum_gy * bn.weight.detach() * (-0.5) * inv ** 3
    dvar = torch.where(ex2 - mean * mean >= 0, dvar, torch.zeros_like(dvar))
    dmean = -(mul * sum_g) - 2.0 * mean * dvar
    dex2 = dvar
    if bn.group is not None:
        from videowalk_tpu_torch.parallel.mesh import (all_reduce_sum,
                                                       group_size)

        packed = torch.cat([dmean, dex2]) / group_size(bn.group)
        dmean, dex2 = all_reduce_sum(packed, bn.group).chunk(2)
    return [mul, dmean / count, dex2 / count], sum_gy * inv, sum_g


class _BnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, s1, s2, weight, bias, sc, yd, weight_d, bias_d, bn,
                bn_d, relu, update):
        mode = (PROJ if yd is not None else IDENTITY if sc is not None
                else PLAIN)
        mean, ex2, prm = _forward_side(
            bn, y, None if s1 is None else (s1, s2), update)
        if mode == PROJ:
            mean_d, ex2_d, prm_d = _forward_side(bn_d, yd, None, update)
            prm += prm_d
            sc = yd
        else:
            mean_d = ex2_d = None
        out = bn_act_fwd(y, torch.stack(prm), sc, mode, relu)
        ctx.save_for_backward(y, yd, out, mean, ex2, mean_d, ex2_d)
        ctx.bn, ctx.bn_d, ctx.mode, ctx.relu = bn, bn_d, mode, relu
        return out

    @staticmethod
    def backward(ctx, go):
        y, yd, out, mean, ex2, mean_d, ex2_d = ctx.saved_tensors
        mode, relu = ctx.mode, ctx.relu
        if y.device.type == "cuda":
            go = _in_layout(go, _nchw("bn_act", "y", y))
        means = [mean] if mode != PROJ else [mean, mean_d]
        sums, dr = bn_act_reduce_bwd(go, out, y, yd, torch.stack(means), mode,
                                     relu)
        count = y.numel() // y.shape[1]
        prm, dw, db = _backward_side(ctx.bn, mean, ex2, sums[0], sums[1],
                                     count)
        dw_d = db_d = None
        if mode == PROJ:
            prm_d, dw_d, db_d = _backward_side(ctx.bn_d, mean_d, ex2_d,
                                               sums[0], sums[2], count)
            prm += prm_d
        if mode == IDENTITY:           # dr is the gated gradient
            dy, dyd = bn_act_apply_bwd(dr, out, y, None, torch.stack(prm),
                                       PLAIN, False)
        else:
            dy, dyd = bn_act_apply_bwd(go, out, y, yd, torch.stack(prm),
                                       mode, relu)
        need = ctx.needs_input_grad
        return (dy, None, None, dw if need[3] else None,
                db if need[4] else None, dr, dyd,
                dw_d if need[7] else None, db_d if need[8] else None,
                None, None, None, None)


class _Moments(torch.autograd.Function):
    """``(y, Σy, Σy²)``: ``y`` itself, and its moments, whose cotangents
    the backward folds into ``y``'s gradient (``bn_fold``)."""

    @staticmethod
    def forward(ctx, y):
        ctx.set_materialize_grads(False)
        s1, s2 = bn_moments(y)
        ctx.save_for_backward(y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        y, = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(y)
        return bn_fold(gy, gs1, gs2, y)


def bn_act_fused(y: torch.Tensor, bn, moments=None, *, shortcut=None,
                 proj=None, relu: bool = False,
                 update: bool = True) -> torch.Tensor:
    """``bn_act`` on the kernels' autograd function (on a CPU tensor, on
    the passes' plain versions). ``moments`` that came from a conv get no
    gradient back: their cotangents are folded into ``y``'s."""
    s1, s2 = moments if moments is not None else (None, None)
    yd, bn_d = proj if proj is not None else (None, None)
    return _BnAct.apply(
        y, s1, s2, bn.weight, bn.bias, shortcut, yd,
        None if bn_d is None else bn_d.weight,
        None if bn_d is None else bn_d.bias, bn, bn_d, bool(relu),
        bool(update))


def bn_affine_fused(y: torch.Tensor, bn, moments=None, *,
                    update: bool = True):
    """``bn_affine`` with the moments from the conv or ``bn_moments``:
    ``(y, a, b)``, ``y`` the tensor to use from here on (through
    ``_Moments`` where the moments were reduced here)."""
    if moments is None:
        y, s1, s2 = _Moments.apply(y)
        moments = (s1, s2)
    mean, var = batch_stats(bn, y, None, moments, update)
    a = torch.rsqrt(var + bn.eps) * bn.weight
    return y, a, bn.bias - mean * a


def bn_act(y: torch.Tensor, bn, moments=None, *, shortcut=None, proj=None,
           relu: bool = False, update: bool = True) -> torch.Tensor:
    """Train-mode ``relu(T(T(BN(y)) + r))`` (module docstring): the eager
    chain on the CPU, the kernels on the card."""
    fused = y.device.type != "cpu"
    _count(fused, 1 + (proj is not None), update,
           (y, bn.weight, shortcut, None if proj is None else proj[0]))
    run = bn_act_fused if fused else bn_act_plain
    return run(y, bn, moments, shortcut=shortcut, proj=proj, relu=relu,
               update=update)


def bn_affine(y: torch.Tensor, bn, moments=None, *, update: bool = True):
    """Train-mode BN of ``y`` as its per-channel affine: ``(y, a, b)``,
    ``a = rsqrt(var + eps)·weight``, ``b = bias − mean·a``, and ``y`` the
    tensor its consumer takes (the same values; on the card, with the
    moments' cotangents to fold where they were reduced here)."""
    fused = y.device.type != "cpu"
    _count(fused, 1, update, (y, bn.weight))
    if fused:
        return bn_affine_fused(y, bn, moments, update=update)
    return (y, *bn_affine_plain(y, bn, moments, update=update))
