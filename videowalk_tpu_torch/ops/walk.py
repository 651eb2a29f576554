"""Fused palindrome-walk loss: forward and backward kernels.

Replaces the Pallas TPU kernels ``videowalk_tpu/ops/walk_kernel.py``
(``_walk_fwd_kernel`` via ``_fwd_call``, ``_walk_bwd_kernel`` via
``_bwd_call``). Per batch element, with S = T - 1:

- forward: ``A_s = q_s q_{s+1}ᵀ``; ``D12_s = where(m12_s, -1e20, A_s) / T``,
  ``D21_s = where(m21_s, -1e20, A_sᵀ) / T``; ``P = zsm(D12)``,
  ``Q = zsm(D21)``; prefix products ``F_0 = P_0``, ``F_i = F_{i-1} P_i``,
  ``B_0 = Q_0``, ``B_i = Q_i B_{i-1}``; ``AA_i = F_i B_i``; per cycle
  i = 1..S-1 the loss ``mean_rows[log(rowsum + N·1e-20) - log(diag + 1e-20)]``
  (the reference's cross-entropy over ``log(AA + eps)``: the log-sum-exp of
  log-probabilities is the log of their sum) and the accuracy
  ``mean_rows[diag >= rowmax]``;
- backward: the hand VJP from the residuals D12, D21, F, B, P, Q, walked
  in reverse, giving dq.

``fused_walk`` is the autograd wrapper: its forward calls ``walk_fwd``, its
backward ``walk_bwd``. Each takes the plain PyTorch version
(``fused_walk_plain_fwd`` / ``_bwd``: the same math, the same residuals)
for a tensor on the CPU, and launches the hand-written Hopper kernel
``csrc/walk.cu`` for a CUDA tensor, or raises. ``walk_fwd.launches`` and
``walk_bwd.launches`` count the wrapper calls that launched the kernels
(each call makes ``DEVICE_LAUNCHES`` device launches, one per phase).

Unlike the TPU kernel there is no 128-lane padding of N and C and no
(8, 128) loss tile: losses and accuracies come out as ``(B, S-1)`` f32.
``walk_supported`` is every shape the JAX model's fused gate takes: 3 <= T
<= 10, N <= 128, with C <= 512. ``fused_walk="auto"`` takes the kernels on
all of it: in the card's sweep (``chip_smoke.py --phases walk``: forward +
backward at batch 8 over T in {4, 8, 10}, N in {48, 49, 64, 96, 128}, C in
{128, 256, 512}; PERF.md §6) the fused walk took at most a third of the
core walk's time at every swept shape.

Bound on the card, at the flagship shape (B=8, T=8, N=49, C=128): the
function's forward reads q (1.6 MB) and the masks (0.27 MB) and writes
the four (B,S,N,N) f32 residuals it needs, D12, D21, F, B (2.2 MB), for
68 MFLOP; the backward reads q and those residuals and writes dq (5.4 MB)
for 148 MFLOP. That is ~1.2-1.6 us of bytes and ~1-2.2 us of f32
operations at the card's peaks, so launch latency and the serial
recursions decide the time. P and Q are the design's own extra residuals
(1.08 MB more a call each way). Each call runs four grids of many blocks
per batch element, the recursions split by rows and columns: see the
source's note.
"""

from __future__ import annotations

import ctypes

import torch

from videowalk_tpu_torch.core.walk import (EPS, NEG, ZSM_EPS, dropout_masks,
                                           zero_softmax)

MAX_T, MAX_N, MAX_C = 10, 128, 512
DEVICE_LAUNCHES = 4     # kernels ``csrc/walk.cu`` launches a call, each way


def walk_supported(T: int, N: int, C: int) -> bool:
    """Shapes the CUDA kernels take (and the model's fused gate admits)."""
    return 3 <= T <= MAX_T and 1 <= N <= MAX_N and 1 <= C <= MAX_C


def _zsm_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """VJP of ``zero_softmax`` at logits ``x`` for the upstream ``dy``."""
    e = torch.expm1(x)
    u = torch.square(e)
    s = u.sum(-1, keepdim=True) + ZSM_EPS
    y = u / s
    du = (dy - (dy * y).sum(-1, keepdim=True)) / s
    return du * 2.0 * e * torch.exp(x)


def fused_walk_plain_fwd(q: torch.Tensor, m12: torch.Tensor,
                         m21: torch.Tensor, temperature: float):
    """Plain PyTorch forward. ``q (B, T, N, C)`` f32, masks ``(B, S, N, N)``
    (nonzero = dropped) -> ``losses, accs (B, S-1)`` and the residuals
    ``d12, d21, f, b, p, qz`` ``(B, S, N, N)`` (``p = zsm(d12)``,
    ``qz = zsm(d21)``, ``f[:, 0] = p[:, 0]``, ``b[:, 0] = qz[:, 0]``)."""
    B, T, N, _ = q.shape
    S = T - 1
    A = q[:, :-1] @ q[:, 1:].transpose(-1, -2)               # (B, S, N, N)
    neg = torch.full_like(A, NEG)
    d12 = torch.where(m12 != 0, neg, A) / temperature
    d21 = torch.where(m21 != 0, neg, A.transpose(-1, -2)) / temperature
    P, Q = zero_softmax(d12), zero_softmax(d21)
    fs, bs, losses, accs = [P[:, 0]], [Q[:, 0]], [], []
    for i in range(1, S):
        fs.append(fs[-1] @ P[:, i])
        bs.append(Q[:, i] @ bs[-1])
        AA = fs[-1] @ bs[-1]
        rowsum = AA.sum(-1) + N * EPS
        diag = torch.diagonal(AA, dim1=-2, dim2=-1)
        losses.append((torch.log(rowsum) - torch.log(diag + EPS)).mean(-1))
        accs.append((diag >= AA.amax(-1)).float().mean(-1))
    return (torch.stack(losses, 1), torch.stack(accs, 1), d12, d21,
            torch.stack(fs, 1), torch.stack(bs, 1), P, Q)


def fused_walk_plain_bwd(q: torch.Tensor, d12: torch.Tensor,
                         d21: torch.Tensor, f: torch.Tensor, b: torch.Tensor,
                         p: torch.Tensor, qz: torch.Tensor,
                         dlosses: torch.Tensor,
                         temperature: float) -> torch.Tensor:
    """Plain PyTorch backward: the residuals and ``dlosses (B, S-1)`` ->
    ``dq (B, T, N, C)``."""
    B, T, N, _ = q.shape
    S = T - 1
    eye = torch.eye(N, dtype=q.dtype, device=q.device)
    dq = torch.zeros_like(q)
    dF = torch.zeros((B, N, N), dtype=q.dtype, device=q.device)
    dB = torch.zeros_like(dF)

    def add_dq(s, dA):
        dq[:, s] += dA @ q[:, s + 1]
        dq[:, s + 1] += dA.transpose(-1, -2) @ q[:, s]

    for i in range(S - 1, 0, -1):
        F, Bk = f[:, i], b[:, i]
        AA = F @ Bk
        rowsum = AA.sum(-1, keepdim=True) + N * EPS
        dlog = ((AA + EPS) / rowsum - eye) * (dlosses[:, i - 1, None, None] / N)
        dAA = dlog / (AA + EPS)
        dF = dF + dAA @ Bk.transpose(-1, -2)
        dB = dB + F.transpose(-1, -2) @ dAA
        dP = f[:, i - 1].transpose(-1, -2) @ dF
        dQ = dB @ b[:, i - 1].transpose(-1, -2)
        dA = (_zsm_bwd(d12[:, i], dP) / temperature
              + (_zsm_bwd(d21[:, i], dQ) / temperature).transpose(-1, -2))
        add_dq(i, dA)
        dF = dF @ p[:, i].transpose(-1, -2)
        dB = qz[:, i].transpose(-1, -2) @ dB
    dA = (_zsm_bwd(d12[:, 0], dF) / temperature
          + (_zsm_bwd(d21[:, 0], dB) / temperature).transpose(-1, -2))
    add_dq(0, dA)
    return dq


def _lib():
    from videowalk_tpu_torch.ops import _build

    lib = _build.load("walk")
    if lib.walk_fwd_launch.argtypes is None:
        lib.walk_fwd_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])
        lib.walk_fwd_launch.restype = ctypes.c_int
        lib.walk_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])
        lib.walk_bwd_launch.restype = ctypes.c_int
        lib.walk_bwd_workspace_floats.argtypes = [ctypes.c_int] * 3
        lib.walk_bwd_workspace_floats.restype = ctypes.c_long
    return lib


def _check(name: str, tensors, shapes, dtypes, device) -> None:
    for (tname, t), shape, dt in zip(tensors, shapes, dtypes):
        if (t.device != device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {tname} must be a contiguous {dt} tensor of shape "
                f"{shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def _kernel_device(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, T, N, C = q.shape
    if not walk_supported(T, N, C):
        raise ValueError(
            f"{name}: the CUDA kernel does not take T={T}, N={N}, C={C} "
            f"(needs 3 <= T <= {MAX_T}, N <= {MAX_N}, C <= {MAX_C})")


def walk_fwd(q: torch.Tensor, m12: torch.Tensor, m21: torch.Tensor,
             temperature: float):
    """Forward of the fused walk (see ``fused_walk_plain_fwd`` for the
    arguments and results). Masks are uint8."""
    if q.device.type == "cpu":
        return fused_walk_plain_fwd(q, m12, m21, temperature)
    _kernel_device("walk_fwd", q)
    B, T, N, C = q.shape
    S = T - 1
    _check("walk_fwd", (("q", q), ("m12", m12), ("m21", m21)),
           ((B, T, N, C), (B, S, N, N), (B, S, N, N)),
           (torch.float32, torch.uint8, torch.uint8), q.device)
    opts = dict(dtype=torch.float32, device=q.device)
    losses, accs = torch.empty((2, B, S - 1), **opts).unbind(0)
    res = torch.empty((6, B, S, N, N), **opts).unbind(0)
    with torch.cuda.device(q.device):
        err = _lib().walk_fwd_launch(
            q.data_ptr(), m12.data_ptr(), m21.data_ptr(), losses.data_ptr(),
            accs.data_ptr(), *(r.data_ptr() for r in res), B, T, N, C,
            float(temperature),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"walk_fwd kernel launch failed: cudaError {err}")
    walk_fwd.launches += 1
    return (losses, accs, *res)


walk_fwd.launches = 0


def walk_bwd(q: torch.Tensor, d12: torch.Tensor, d21: torch.Tensor,
             f: torch.Tensor, b: torch.Tensor, p: torch.Tensor,
             qz: torch.Tensor, dlosses: torch.Tensor,
             temperature: float) -> torch.Tensor:
    """Backward of the fused walk -> ``dq (B, T, N, C)``."""
    if q.device.type == "cpu":
        return fused_walk_plain_bwd(q, d12, d21, f, b, p, qz, dlosses,
                                    temperature)
    _kernel_device("walk_bwd", q)
    B, T, N, C = q.shape
    S = T - 1
    sq = (B, S, N, N)
    res = (d12, d21, f, b, p, qz)
    _check("walk_bwd", (("q", q), ("d12", d12), ("d21", d21), ("f", f),
                        ("b", b), ("p", p), ("qz", qz), ("dlosses", dlosses)),
           ((B, T, N, C),) + (sq,) * 6 + ((B, S - 1),),
           (torch.float32,) * 8, q.device)
    lib = _lib()
    dq = torch.empty_like(q)
    # the phases' N x N matrices: X_i (then dD12), Y_i (then dD21), dF_i,
    # dB_i, dD12^T, dD21^T
    ws = torch.empty((int(lib.walk_bwd_workspace_floats(B, T, N)),),
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.walk_bwd_launch(
            q.data_ptr(), *(r.data_ptr() for r in res), dlosses.data_ptr(),
            dq.data_ptr(), ws.data_ptr(), B, T, N, C, float(temperature),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"walk_bwd kernel launch failed: cudaError {err}")
    walk_bwd.launches += 1
    return dq


walk_bwd.launches = 0


class _FusedWalk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, m12, m21, temperature):
        losses, accs, *res = walk_fwd(q, m12, m21, temperature)
        ctx.save_for_backward(q, *res)
        ctx.temperature = temperature
        ctx.mark_non_differentiable(accs)
        return losses, accs

    @staticmethod
    def backward(ctx, dlosses, _daccs):
        q, *res = ctx.saved_tensors
        dq = walk_bwd(q, *res, dlosses.contiguous().float(), ctx.temperature)
        return dq, None, None, None


def fused_walk(q: torch.Tensor, m12: torch.Tensor, m21: torch.Tensor,
               temperature: float):
    """Differentiable per-(b, cycle) ``losses, accs (B, S-1)`` of
    ``q (B, T, N, C)``; the gradient flows to q through ``walk_bwd``."""
    return _FusedWalk.apply(q, m12, m21, float(temperature))


def fused_walk_loss(
    q: torch.Tensor, temperature: float, *,
    generator: torch.Generator | None = None, edgedrop_rate: float = 0.0,
    masks: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Fused counterpart of ``core.walk.crw_walk_loss`` (ZeroSoftmax, no
    flip, no zeroed diagonal) on ``q (B, C, T, N)``: the same loss and
    ``xent/acc cyc r{i}`` diagnostics. Masks ``(B, S, N, N)`` are given or
    drawn here from ``generator``, outside the kernel, as the JAX package
    draws them."""
    B, C, T, N = q.shape
    if T < 3:
        return torch.zeros((), dtype=torch.float32, device=q.device), {}
    S = T - 1
    qt = q.permute(0, 2, 3, 1).float().contiguous()          # (B, T, N, C)
    if masks is None and edgedrop_rate > 0:
        masks = dropout_masks((B, S, N, N), edgedrop_rate, generator,
                              q.device)
    if masks is None:
        m12 = m21 = torch.zeros((B, S, N, N), dtype=torch.uint8,
                                device=q.device)
    else:
        m12, m21 = (m.to(device=q.device, dtype=torch.uint8).contiguous()
                    for m in masks)
    losses, accs = fused_walk(qt, m12, m21, temperature)
    loss = losses.sum(-1).mean() / max(1, S - 1)
    diags = {}
    for i in range(S - 1):
        diags[f"xent cyc r{i + 1}"] = losses[:, i].mean()
        diags[f"acc cyc r{i + 1}"] = accs[:, i].mean()
    return loss, diags
