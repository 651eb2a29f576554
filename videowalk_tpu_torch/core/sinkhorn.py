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


def sinkhorn_knopp(A: torch.Tensor, tol: float = 0.01,
                   max_iter: int = 1000) -> torch.Tensor:
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
    iterations."""
    A = A / A.sum(dim=(-1, -2), keepdim=True)
    it = 0
    while it == 0 or (it < max_iter and float(A.sum(dim=-2).std()) > tol):
        A = _l1_normalize(_l1_normalize(A, dim=-2), dim=-1)
        it += 1
    return A
