"""Data parallelism over a ``torch.distributed`` process group (counterpart
of ``videowalk_tpu/parallel/mesh.py``).

The JAX package shards the batch over a mesh and lets XLA insert the
gradient psum; BN's moments are then over the global batch. Here each rank
holds its row block of the global batch, and the collectives are explicit:

- ``all_reduce_sum``: a differentiable SUM (its backward is the SUM of the
  gradient), used for BN's moments (``models/resnet.py``) and Sinkhorn's
  stop test (``core/sinkhorn.py``);
- ``average_gradients``: one flat all-reduce of the gradients after the
  backward pass (``parallel/train_step.py``);
- ``replicate``: rank 0's parameters and buffers on every rank.

Both all-reduce functions, and the SUM's backward, run in the span
``dp.all_reduce`` (``utils/profile.py``).

A manual average suits the plain step function: the patch and superpixel
paths use different parameter sets, where DDP would need
``find_unused_parameters``.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from videowalk_tpu_torch.utils.profile import span, spanned


def group_size(group) -> int:
    return dist.get_world_size(group)


def shard_batch(x, rank: int, world: int):
    """The rank's row block of the global batch ``x`` (a tensor or array,
    or a dict / tuple / list of them): rows ``[rank * B / world, (rank + 1)
    * B / world)``. The batch must split evenly."""
    if isinstance(x, dict):
        return {k: shard_batch(v, rank, world) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(shard_batch(v, rank, world) for v in x)
    B = x.shape[0]
    if B % world:
        raise ValueError(f"batch {B} does not split over {world} ranks")
    b = B // world
    return x[rank * b:(rank + 1) * b]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        with span("dp.all_reduce"):
            g = g.clone()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


@spanned("dp.all_reduce")
def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The SUM of ``x`` over ``group``, differentiable: the gradient of each
    rank's input is the SUM of the ranks' output gradients (every rank's
    loss depends on every rank's input)."""
    return _AllReduceSum.apply(x, group)


def _by_dtype(tensors: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def _coalesced(tensors: list[torch.Tensor], fn) -> None:
    """``fn(flat)`` on one flat buffer per dtype of ``tensors``, copied
    back into them."""
    for ts in _by_dtype(tensors):
        flat = _flatten_dense_tensors(ts)
        fn(flat)
        for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(v)


@spanned("dp.all_reduce")
def average_gradients(params: Iterable[torch.Tensor], group) -> None:
    """Replace each gradient by its mean over ``group``: one flat SUM
    all-reduce, then a divide by the group size. Parameters without a
    gradient (frozen, or not on this step's path) stay out; every rank
    must hold gradients for the same parameters."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    w = group_size(group)

    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(w)

    with torch.no_grad():
        _coalesced(grads, mean)


def global_mean(metrics: dict, group) -> dict:
    """Each 0-d metric of ``metrics`` averaged over ``group`` (one
    all-reduce): the global batch's figure where every rank holds an equal
    row block."""
    keys = list(metrics)
    if not keys:
        return {}
    v = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(v, op=dist.ReduceOp.SUM, group=group)
    v = v / group_size(group)
    return {k: v[i] for i, k in enumerate(keys)}


def replicate(model: nn.Module, group) -> nn.Module:
    """Broadcast ``model``'s parameters and buffers from the group's rank 0
    (one flat broadcast per dtype), then check that every rank holds the
    same values (one MAX and one MIN all-reduce per dtype); raises where
    they differ. The JAX package relies on a seeded init; this checks it."""
    src = (0 if group in (None, dist.group.WORLD)
           else dist.get_global_rank(group, 0))
    tensors = [t.data for t in model.parameters()] + [
        b for b in model.buffers()]

    def bcast(flat):
        dist.broadcast(flat, src=src, group=group)

    def check(flat):
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        if not (torch.equal(hi, flat) and torch.equal(lo, flat)):
            raise RuntimeError("replicate: the ranks' parameters differ "
                               "after the broadcast")

    with torch.no_grad():
        _coalesced(tensors, bcast)
        for ts in _by_dtype(tensors):
            check(_flatten_dense_tensors(ts))
    return model


def attach_group(model: nn.Module, group) -> nn.Module:
    """Attach ``group`` to every train-mode ``BatchNorm`` of ``model`` (its
    moments then span the group's global batch) and to every module that
    carries a ``group`` for its own collectives (``CRW``'s Sinkhorn stop
    test). ``None`` detaches."""
    from videowalk_tpu_torch.models.crw import CRW
    from videowalk_tpu_torch.models.resnet import BatchNorm

    for m in model.modules():
        if isinstance(m, (BatchNorm, CRW)):
            m.group = group
    return model
