"""CRW train step: forward, backward, Adam (or SGD) and a per-step
MultiStep LR (counterpart of ``videowalk_tpu/parallel/train_step.py``;
reference ``code/train.py:36-107``).

PyTorch runs eagerly, so there is no compiled step: ``make_train_step``
returns a function that runs one step on the state's model and optimizer
and updates the parameters, the BN running statistics and the optimizer's
moments *in place* (the JAX step returns a new state instead).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from videowalk_tpu_torch.models.crw import CRW
from videowalk_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    """The model (parameters + BN running statistics) on ``device``, its
    optimizer, the per-step LR schedule and the count of steps taken."""

    model: CRW
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    device: torch.device
    step: int = 0


def make_optimizer(
    lr: float = 1e-4,
    milestones: Sequence[int] = (),
    gamma: float = 0.3,
    optim: str = "adam",
    momentum: float = 0.9,
) -> Callable:
    """Adam (reference default, ``code/train.py:249``: betas 0.9/0.999,
    eps 1e-8, no weight decay) or SGD with ``momentum`` (``--optim sgd``),
    under a per-step MultiStepLR: the LR of update ``k`` (0-based) is
    ``lr * gamma ** #{m in milestones: k >= m}``, as
    ``optax.piecewise_constant_schedule`` gives it.

    Returns ``build(params) -> (optimizer, scheduler)``: a torch optimizer
    binds its parameters, so it is built with the model."""
    if optim not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {optim!r}")
    steps = sorted({int(m) for m in milestones})

    def build(params):
        if optim == "adam":
            opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                   eps=1e-8, weight_decay=0.0)
        else:
            opt = torch.optim.SGD(params, lr=lr, momentum=momentum)
        sched = torch.optim.lr_scheduler.MultiStepLR(opt, steps, gamma)
        return opt, sched

    return build


def create_train_state(model: CRW, optimizer: Callable,
                       device: str | torch.device = "cuda") -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller asks for
    ``'cpu'``; raises where CUDA is asked for and missing) and bind
    ``make_optimizer``'s ``optimizer`` to its parameters there. The model is
    already initialized (seed it when it is built)."""
    model.to(resolve_device(device))
    opt, sched = optimizer(model.parameters())
    return TrainState(model=model, optimizer=opt, scheduler=sched,
                      device=next(model.parameters()).device)  # with its index


def make_train_step() -> Callable:
    """``step(state, batch, generator, sp_mask=None) -> metrics``.

    One reference training step on ``batch`` (patches
    ``(B, T, N, h, w, 3)``, or whole frames ``(B, T, h, w, 3)`` with their
    superpixel ids ``sp_mask (B, T, h, w)``; both on ``state.device``,
    another device raises): forward in train mode (BN batch statistics;
    edge dropout and featdrop drawn from ``generator``, a
    ``torch.Generator`` on that device),
    backward, an optimizer step and a scheduler step. Parameters, BN
    running statistics and optimizer state are updated in place.
    ``metrics`` holds the loss and the walk diagnostics as detached 0-d
    tensors on the device (reading them synchronizes; the step itself does
    not)."""

    def step(state: TrainState, batch: torch.Tensor,
             generator: torch.Generator | None = None,
             sp_mask: torch.Tensor | None = None) -> dict:
        for name, t in (("batch", batch), ("sp_mask", sp_mask)):
            if t is not None and t.device != state.device:
                raise ValueError(f"{name} on {t.device}, train state on "
                                 f"{state.device}")
        state.optimizer.zero_grad(set_to_none=True)
        _, loss, diags = state.model(batch, sp_mask=sp_mask, train=True,
                                     generator=generator)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in diags.items()}}

    return step
