"""Sinkhorn-Knopp doubly-stochastic normalization (counterpart of
``videowalk_tpu/core/sinkhorn.py``; reference ``code/utils/__init__.py:615-639``).

Used by the experimental ``--sk-targets`` walk loss and
``stoch_mat(do_sinkhorn=True)`` (``core/walk.py``). The JAX package's
``lax.while_loop`` is a Python loop here, with the same stopping rule.
"""

from __future__ import annotations

import torch


def _l1_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``F.normalize(p=1)`` semantics: ``x / max(sum |x|, 1e-12)``."""
    return x / torch.clamp(x.abs().sum(dim=dim, keepdim=True), min=1e-12)


def _colsum_std(A: torch.Tensor, group) -> float:
    """``std(colsums, ddof=1)`` over every matrix of the batch: of this
    process's ``A`` alone, or, with a process group, of the global batch,
    from all-reduced f64 ``(n, sum, sum of squares)``, so that every rank
    takes the same number of iterations."""
    cs = A.sum(dim=-2)
    if group is None:
        return float(cs.std())
    import torch.distributed as dist

    c = cs.detach().double()
    st = torch.stack([c.new_tensor(float(c.numel())), c.sum(),
                      (c * c).sum()])
    dist.all_reduce(st, op=dist.ReduceOp.SUM, group=group)
    n, s, s2 = st.tolist()
    return max(s2 - s * s / n, 0.0) ** 0.5 / (n - 1) ** 0.5


def sinkhorn_knopp(A: torch.Tensor, tol: float = 0.01,
                   max_iter: int = 1000, group=None) -> torch.Tensor:
    """Alternate column and row L1 normalization of the non-negative
    ``(..., N, M)`` ``A`` until the column sums settle.

    ``A`` is first divided by its total over the last two axes. Then at
    least one iteration runs, and the loop stops once
    ``std(colsums, ddof=1) <= tol`` or after ``max_iter`` iterations. The
    std is one scalar over the column sums of *every* matrix of the batch
    (as ``jnp.std`` over the whole ``(..., M)`` array), so all matrices of a
    batch take the same number of iterations.

    On the card the stop test reads one scalar back to the host each
    iteration (a sync per iteration): acceptable on this experimental path,
    which the main training paths do not take. Differentiable through the
    iterations.

    ``group``: a ``torch.distributed`` process group whose ranks hold row
    blocks of the global batch; the stop test is then the global batch's
    (the JAX ``cond`` reduces over the global array), and each test is one
    all-reduce."""
    A = A / A.sum(dim=(-1, -2), keepdim=True)
    it = 0
    while it == 0 or (it < max_iter and _colsum_std(A, group) > tol):
        A = _l1_normalize(_l1_normalize(A, dim=-2), dim=-1)
        it += 1
    return A
