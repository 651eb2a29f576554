"""Contrastive-random-walk loss math (counterpart of
``videowalk_tpu/core/walk.py``; reference ``code/model.py``).

Layouts follow the JAX package: node embeddings ``q`` are ``(B, C, T, N)``.
Edge-dropout masks are ``(B, S, N, N)`` booleans (S = T - 1), the layout of
the fused walk kernel (``ops/walk.py``): ``m12[b, s]`` drops entries of the
forward logits ``A_s``, ``m21[b, s]`` entries of the backward logits
``A_sᵀ``. They are drawn from an explicit ``torch.Generator``, or given.

The dropout fill of -1e20 goes in *before* the divide by temperature, so a
dropped edge gets the ZeroSoftmax weight ``(e^-inf - 1)^2 = 1``, not 0:
the reference's semantics, kept as they are.

Matrix products are plain f32 (on the card ``torch.backends.cuda.matmul.
allow_tf32`` must stay off, as it is by default: logits reach +-20 at
T 0.05, so TF32's ~1e-3 error in an affinity moves a ZeroSoftmax weight by
~4%).
"""

from __future__ import annotations

import torch

from videowalk_tpu_torch.core import rng
from videowalk_tpu_torch.core.sinkhorn import sinkhorn_knopp

EPS = 1e-20          # reference code/model.py:12
L2_NORM_EPS = 1e-12  # torch.nn.functional.normalize's default eps
ZSM_EPS = 1e-5       # ZeroSoftmax eps (reference code/utils/__init__.py:418)
NEG = -1e20          # edge-dropout fill (reference code/model.py:81)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x / max(||x||_2, 1e-12)``, with all-zero vectors mapped to zero
    *and given a zero gradient* (the double-where of the JAX package).
    ``F.normalize`` returns ``g / 1e-12`` there, which would blow up the
    encoder gradient from padded (all-zero) superpixel slots."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    nonzero = sq > 0
    safe = torch.where(nonzero, sq, torch.ones_like(sq))
    out = x / torch.clamp(torch.sqrt(safe), min=L2_NORM_EPS)
    return torch.where(nonzero, out, torch.zeros_like(out))


def affinity(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``(B, C, T, N), (B, C, T, M) -> (B, T, N, M)`` f32 affinities.
    Reference code/model.py:63-72."""
    return torch.einsum("bctn,bctm->btnm", x1.float(), x2.float())


def zero_softmax(x: torch.Tensor, dim: int = -1,
                 eps: float = ZSM_EPS) -> torch.Tensor:
    """``(e^x - 1)^2 / (sum (e^x - 1)^2 + eps)``: zero logits get exactly
    zero probability. Reference code/utils/__init__.py:414-422."""
    u = torch.square(torch.expm1(x))
    return u / (u.sum(dim=dim, keepdim=True) + eps)


def dropout_masks(shape, rate: float,
                  generator: torch.Generator | None,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Independent Bernoulli(``rate``) edge-drop masks ``(m12, m21)`` of
    ``shape`` (bool), one per direction, from ``generator`` (which must live
    on ``device``; a ``core.rng.GlobalBatchGenerator`` keeps its rank's
    rows of the global batch's draw)."""
    if generator is None:
        raise ValueError("edge dropout needs a torch.Generator")
    m12 = rng.rand(shape, generator, device) < rate
    m21 = rng.rand(shape, generator, device) < rate
    return m12, m21


def edge_dropout(A: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``A`` with the entries of ``mask`` set to -1e20 (reference
    code/model.py:80-81, ``A[rand < p] = -1e20``, with the mask given)."""
    return torch.where(mask.bool(), torch.full_like(A, NEG), A)


def stoch_mat(A: torch.Tensor, temperature: float, *,
              mask: torch.Tensor | None = None,
              zero_diagonal: bool = False, do_sinkhorn: bool = False,
              use_zero_softmax: bool = True) -> torch.Tensor:
    """Affinity logits -> row-stochastic transition matrix (reference
    code/model.py:74-90): optional zeroed diagonal, the dropout fill where
    ``mask`` is set, then (Zero)Softmax of ``A / temperature``, or with
    ``do_sinkhorn`` the doubly-stochastic ``sinkhorn_knopp(exp(A / T))``
    (tol 0.01, at most 100 iterations)."""
    if zero_diagonal:
        n = A.shape[-1]
        A = A * (1.0 - torch.eye(n, dtype=A.dtype, device=A.device))
    if mask is not None:
        A = edge_dropout(A, mask)
    if do_sinkhorn:
        return sinkhorn_knopp(torch.exp(A / temperature), tol=0.01,
                              max_iter=100)
    if use_zero_softmax:
        return zero_softmax(A / temperature, dim=-1)
    return torch.softmax(A / temperature, dim=-1)


def transition_matrices(
    q: torch.Tensor, temperature: float, *,
    generator: torch.Generator | None = None, edgedrop_rate: float = 0.0,
    masks: tuple[torch.Tensor, torch.Tensor] | None = None,
    use_zero_softmax: bool = True, zero_diagonal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``q (B, C, T, N)`` -> forward / backward transition matrices, each
    ``(S, B, N, N)`` (the JAX package's stacked layout).

    Dropout: ``masks`` ``(m12, m21)`` of shape ``(B, S, N, N)`` when given,
    else drawn from ``generator`` when ``edgedrop_rate > 0``.
    Reference code/model.py:368-374."""
    As = affinity(q[:, :, :-1], q[:, :, 1:])            # (B, S, N, N)
    if zero_diagonal:
        n = As.shape[-1]
        As = As * (1.0 - torch.eye(n, dtype=As.dtype, device=As.device))
    AsT = As.transpose(-1, -2)
    if masks is None and edgedrop_rate > 0:
        masks = dropout_masks(As.shape, edgedrop_rate, generator, As.device)
    if masks is not None:
        As = edge_dropout(As, masks[0])
        AsT = edge_dropout(AsT, masks[1])
    sm = zero_softmax if use_zero_softmax else torch.softmax
    A12s = sm(As / temperature, dim=-1).transpose(0, 1)
    A21s = sm(AsT / temperature, dim=-1).transpose(0, 1)
    return A12s, A21s


def palindrome_products(A12s: torch.Tensor, A21s: torch.Tensor, *,
                        flip: bool = False) -> torch.Tensor:
    """``(S, B, N, N)`` transitions -> ``(S-1, B, N, N)`` cycle products.

    Prefix products, as the JAX package associates them:
    ``F_i = F_{i-1} A12_i``, ``B_i = A21_i B_{i-1}``, ``AA_i = F_i B_i``
    (``flip``: ``L_i = L_{i-1} A21_i``, ``R_i = A12_i R_{i-1}``,
    ``AA_i = L_i R_i``). Reference code/model.py:376-382."""
    if flip:
        L, R = A21s[0], A12s[0]
    else:
        L, R = A12s[0], A21s[0]
    out = []
    for i in range(1, A12s.shape[0]):
        if flip:
            L, R = L @ A21s[i], A12s[i] @ R
        else:
            L, R = L @ A12s[i], A21s[i] @ R
        out.append(L @ R)
    return torch.stack(out)


def sk_targets_walk_loss(
    q: torch.Tensor, temperature: float, *,
    generator: torch.Generator | None = None, edgedrop_rate: float = 0.0,
    masks: tuple[torch.Tensor, torch.Tensor] | None = None,
    use_zero_softmax: bool = False, sk_tol: float = 0.001,
    sk_max_iter: int = 10, group=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The experimental ``--sk-targets`` walk loss of ``q (B, C, T, N)``
    (reference code/teacherstudent.py:174-182).

    The forward chain ``a12_i = A12_0 ... A12_i`` (edge dropout on the
    forward logits only: one mask, ``masks[0]`` when given, else drawn from
    ``generator`` at ``edgedrop_rate``) is scored against the row argmax of
    ``sinkhorn_knopp(at_i, sk_tol, sk_max_iter)``, where ``at_i = Ats_i ...
    Ats_0`` chains the dropout-free ``Ats = sinkhorn_knopp(exp(A / T),
    0.01, 100)``. The targets carry no gradient. Returns the mean over the
    T-2 cycles and ``xent sk {i}`` / ``acc sk {i}``; T < 3: loss 0, no
    diagnostics. ``group``: Sinkhorn's stop test over the process group's
    global batch (``core/sinkhorn.py``)."""
    T = q.shape[2]
    if T < 3:
        return torch.zeros((), dtype=torch.float32, device=q.device), {}
    As = affinity(q[:, :, :-1], q[:, :, 1:])            # (B, S, N, N)
    if masks is not None:
        mask = masks[0]
    elif edgedrop_rate > 0:
        if generator is None:
            raise ValueError("edge dropout needs a torch.Generator")
        mask = rng.rand(As.shape, generator, As.device) < edgedrop_rate
    else:
        mask = None
    drop = As if mask is None else edge_dropout(As, mask)
    sm = zero_softmax if use_zero_softmax else torch.softmax
    A12s = sm(drop / temperature, dim=-1).transpose(0, 1)   # (S, B, N, N)
    with torch.no_grad():
        Ats = sinkhorn_knopp(torch.exp(As.transpose(0, 1) / temperature),
                             tol=0.01, max_iter=100, group=group)
    a12, at = A12s[0], Ats[0]
    losses, accs = [], []
    for i in range(1, T - 1):
        a12 = a12 @ A12s[i]
        with torch.no_grad():
            at = Ats[i] @ at
            target = sinkhorn_knopp(at, tol=sk_tol, max_iter=sk_max_iter,
                                    group=group).argmax(dim=-1)
        logits = torch.log(a12 + EPS)
        picked = logits.gather(-1, target[..., None])[..., 0]
        losses.append((torch.logsumexp(logits, dim=-1) - picked).mean())
        accs.append((logits.argmax(dim=-1) == target).float().mean())
    loss = torch.stack(losses).sum() / max(1, T - 2)
    diags = {}
    for i in range(T - 2):
        diags[f"xent sk {i + 1}"] = losses[i]
        diags[f"acc sk {i + 1}"] = accs[i]
    return loss, diags


def walk_xent_loss(AA: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy of ``(B, N, N)`` cycle products against identity
    targets: ``logsumexp(log(AA + EPS)) - log(AA_nn + EPS)`` averaged, and
    the accuracy of the row argmax (reference code/model.py:394-399, which
    applies CrossEntropyLoss on top of the log)."""
    logits = torch.log(AA + EPS)
    lse = torch.logsumexp(logits, dim=-1)
    diag = torch.diagonal(logits, dim1=-2, dim2=-1)
    loss = (lse - diag).mean()
    target = torch.arange(AA.shape[-1], device=AA.device)
    acc = (logits.argmax(dim=-1) == target).float().mean()
    return loss, acc


def crw_walk_loss(
    q: torch.Tensor, temperature: float, *,
    generator: torch.Generator | None = None, edgedrop_rate: float = 0.0,
    masks: tuple[torch.Tensor, torch.Tensor] | None = None,
    flip: bool = False, use_zero_softmax: bool = True,
    zero_diagonal: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The CRW palindrome loss of ``q (B, C, T, N)``: the mean over the T-2
    cycles, and per-cycle ``xent cyc {r|l}{i}`` / ``acc cyc {r|l}{i}``
    diagnostics. T < 3 has no cycle: loss 0, no diagnostics. Reference
    code/model.py:334-415."""
    T = q.shape[2]
    if T < 3:
        return torch.zeros((), dtype=torch.float32, device=q.device), {}
    A12s, A21s = transition_matrices(
        q, temperature, generator=generator, edgedrop_rate=edgedrop_rate,
        masks=masks, use_zero_softmax=use_zero_softmax,
        zero_diagonal=zero_diagonal)
    AAs = palindrome_products(A12s, A21s, flip=flip)
    losses, accs = zip(*(walk_xent_loss(AA) for AA in AAs))
    loss = torch.stack(losses).sum() / max(1, T - 2)
    tag = "l" if flip else "r"
    diags = {}
    for i in range(T - 2):
        diags[f"xent cyc {tag}{i + 1}"] = losses[i]
        diags[f"acc cyc {tag}{i + 1}"] = accs[i]
    return loss, diags
