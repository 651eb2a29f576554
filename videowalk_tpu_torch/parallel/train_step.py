"""CRW train step: forward, backward, Adam (or SGD) and a per-step
MultiStep LR, for ``CRW`` and ``CRWTeacherStudent`` (counterpart of
``videowalk_tpu/parallel/train_step.py``; reference ``code/train.py:36-107``).

PyTorch runs eagerly, so there is no compiled step: ``make_train_step``
returns a function that runs one step on the state's model and optimizer
and updates the parameters, the BN running statistics and the optimizer's
moments *in place* (the JAX step returns a new state instead).

Data parallel (``create_train_state(group=...)``): each rank steps its row
block of the global batch; BN's moments span the group
(``parallel/mesh.py::attach_group``), the gradients are averaged over
it after the backward pass and the metrics are the global batch's, so
every rank holds the same parameters after every step, as the JAX step on
a mesh gives them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch
from torch import nn

from videowalk_tpu_torch.parallel.mesh import (attach_group,
                                               average_gradients,
                                               global_mean, replicate)
from videowalk_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    """The model (parameters + BN running statistics) on ``device``, its
    optimizer, the per-step LR schedule, the count of steps taken and the
    data-parallel process group (None: one process)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    device: torch.device
    step: int = 0
    group: Any = None


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


def create_train_state(model: nn.Module, optimizer: Callable,
                       device: str | torch.device = "cuda",
                       frozen_prefixes: Sequence[str] = (),
                       group=None) -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller asks for
    ``'cpu'``; raises where CUDA is asked for and missing) and bind
    ``make_optimizer``'s ``optimizer`` to its parameters there. The model is
    already initialized (seed it when it is built).

    Parameters whose ``state_dict`` name starts with one of
    ``frozen_prefixes`` (``("teacher.",)`` for ``CRWTeacherStudent``) get
    ``requires_grad_(False)`` and stay out of the optimizer, so no step
    moves them (the JAX step zeroes their updates).

    ``group``: a ``torch.distributed`` process group to train data-parallel
    over. It is attached to the model's BN layers and Sinkhorn
    (``attach_group``), and rank 0's parameters and buffers are
    broadcast to every rank and checked equal (``replicate``)."""
    model.to(resolve_device(device))
    if group is not None:
        attach_group(model, group)
        replicate(model, group)
    prefixes = tuple(frozen_prefixes)
    trained = []
    for name, p in model.named_parameters():
        if name.startswith(prefixes):
            p.requires_grad_(False)
        else:
            trained.append(p)
    opt, sched = optimizer(trained)
    return TrainState(model=model, optimizer=opt, scheduler=sched,
                      device=next(model.parameters()).device,  # with its index
                      group=group)


def make_train_step() -> Callable:
    """``step(state, batch, generator, sp_mask=None) -> metrics``.

    One reference training step on ``batch`` (patches
    ``(B, T, N, h, w, 3)``, or for ``CRW`` whole frames ``(B, T, h, w, 3)``
    with their superpixel ids ``sp_mask (B, T, h, w)``; both on
    ``state.device``, another device raises): forward in train mode (BN
    batch statistics; edge dropout and featdrop drawn from ``generator``, a
    ``torch.Generator`` on that device; a teacher-student model's teacher
    runs in eval mode),
    backward, an optimizer step and a scheduler step. Parameters, BN
    running statistics and optimizer state are updated in place.
    ``metrics`` holds the loss and the walk diagnostics as detached 0-d
    tensors on the device (reading them synchronizes; the step itself does
    not).

    With a group on the state, ``batch`` is this rank's row block of the
    global batch and ``generator`` a ``core.rng.GlobalBatchGenerator``
    seeded alike on every rank; the gradients are averaged over the group
    (one flat all-reduce) before the update, and ``metrics`` are the
    global batch's means (one more all-reduce)."""

    def step(state: TrainState, batch: torch.Tensor,
             generator: torch.Generator | None = None,
             sp_mask: torch.Tensor | None = None) -> dict:
        for name, t in (("batch", batch), ("sp_mask", sp_mask)):
            if t is not None and t.device != state.device:
                raise ValueError(f"{name} on {t.device}, train state on "
                                 f"{state.device}")
        state.optimizer.zero_grad(set_to_none=True)
        kwargs = {} if sp_mask is None else {"sp_mask": sp_mask}
        _, loss, diags = state.model(batch, train=True, generator=generator,
                                     **kwargs)
        loss.backward()
        if state.group is not None:
            average_gradients(state.model.parameters(), state.group)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in diags.items()}}
        if state.group is not None:
            metrics = global_mean(metrics, state.group)
        return metrics

    return step
