"""Teacher-student CRW (counterpart of
``videowalk_tpu/models/teacher_student.py``; reference
``code/teacherstudent.py:270-580``).

A trainable student (encoder + head) and a frozen teacher of the same
shape walk the same patch grids in parallel. The student's walks carry
edge dropout, the teacher's none; both use plain softmax
(``use_zero_softmax=False``, code/teacherstudent.py:80,389) and heads with
a bias. The loss is ``alpha * CRW + (1 - alpha) * TS``: the student's
palindrome cross-entropy and the soft cross-entropy of its cycle products
against the teacher's.

The teacher runs in BN-eval mode (no running-statistics update, no
featdrop) under ``torch.no_grad()``, the JAX package's ``stop_gradient``;
the train step also leaves its parameters out of the optimizer
(``create_train_state(..., frozen_prefixes=("teacher.",))``).
``state_dict`` names are the reference's: ``encoder.*`` and
``selfsim_fc.*`` for the student, ``teacher.encoder.*`` and
``teacher.selfsim_fc.*`` for the teacher.
"""

from __future__ import annotations

import dataclasses

import torch

from videowalk_tpu_torch.core import walk as walk_lib
from videowalk_tpu_torch.models.crw import CRW, CRWConfig


def soft_cross_entropy(inputs: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """``mean over rows of sum(-target * log_softmax(inputs))``
    (reference code/teacherstudent.py:283-292). The reference feeds walk
    *probabilities*, not logits, into the ``log_softmax``; so do the
    callers here."""
    return torch.sum(-target * torch.log_softmax(inputs, dim=-1),
                     dim=-1).mean()


class CRWTeacherStudent(CRW):
    """``forward(x, train=True, generator=None, walk_masks=None) ->
    (q, loss, diags)`` on patch grids ``x (B, T, N, h, w, 3)`` only.

    ``q`` is the student's ``(B, C, T, N)`` nodes; ``diags`` holds
    ``crw_loss``, ``ts_loss`` and the student's per-cycle ``xent cyc
    {r|l}{i}`` / ``acc cyc {r|l}{i}``. ``generator`` draws the student's
    featdrop and edge dropout; ``walk_masks`` ``(m12, m21)`` replace the
    drawn edge-dropout masks. T < 3 has no cycle: q and zero losses."""

    def __init__(self, cfg: CRWConfig, alpha: float = 0.5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha={alpha}: must be in [0, 1]")
        if cfg.sk_targets or cfg.zero_diagonal:
            # the reference's teacher-student forward ignores both flags;
            # refusing beats training another objective than they promise
            raise ValueError(
                "--sk-targets/--zero-diagonal are not supported by the "
                "teacher-student model (the reference's TS forward ignores "
                "them too); drop the flag or train plain CRW")
        cfg = dataclasses.replace(cfg, head_bias=True)
        super().__init__(cfg)
        self.alpha = alpha
        self.teacher = CRW(cfg)

    def forward(self, x: torch.Tensor, train: bool = True,
                generator: torch.Generator | None = None, walk_masks=None):
        if x.dim() != 6:
            raise ValueError("the teacher-student model takes patch grids "
                             f"(B, T, N, h, w, 3) only; got {tuple(x.shape)}")
        cfg = self.cfg
        q, _ = self.pixels_to_nodes(x, train, generator)
        T = q.shape[2]
        if T < 3:
            zero = torch.zeros((), dtype=q.dtype, device=q.device)
            return q, zero, {"crw_loss": zero, "ts_loss": zero}

        A12s, A21s = walk_lib.transition_matrices(
            q, cfg.temperature, generator=generator,
            edgedrop_rate=cfg.edgedrop_rate if train else 0.0,
            masks=walk_masks if train else None, use_zero_softmax=False)
        AAs = walk_lib.palindrome_products(A12s, A21s, flip=cfg.flip)
        with torch.no_grad():
            q_t, _ = self.teacher.pixels_to_nodes(x, train=False)
            AAs_t = walk_lib.palindrome_products(
                *walk_lib.transition_matrices(q_t, cfg.temperature,
                                              use_zero_softmax=False),
                flip=cfg.flip)

        losses, accs = zip(*(walk_lib.walk_xent_loss(AA) for AA in AAs))
        crw_loss = torch.stack(losses).sum() / max(1, T - 2)
        N = AAs.shape[-1]
        ts_loss = torch.stack([
            soft_cross_entropy(AA.reshape(-1, N), AA_t.reshape(-1, N))
            for AA, AA_t in zip(AAs, AAs_t)]).sum() / max(1, T - 2)
        loss = self.alpha * crw_loss + (1.0 - self.alpha) * ts_loss

        tag = "l" if cfg.flip else "r"
        diags = {"crw_loss": crw_loss, "ts_loss": ts_loss}
        for i in range(T - 2):
            diags[f"xent cyc {tag}{i + 1}"] = losses[i]
            diags[f"acc cyc {tag}{i + 1}"] = accs[i]
        return q, loss, diags
