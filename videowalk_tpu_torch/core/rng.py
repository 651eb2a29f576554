"""Random draws of the global batch, kept by row block.

A data-parallel step must draw what one process would draw for the whole
global batch (the JAX step draws over the global array): edge dropout,
featdrop and the device augmentations. ``GlobalBatchGenerator`` is a
``torch.Generator`` that carries the rank's ``(rank, world)``; ``rand`` and
``randint`` draw with it at the global shape (the leading axis ``world``
times the local one) and keep the rank's rows. Every rank seeds it alike,
so all ranks draw the same global numbers. With a plain generator they are
``torch.rand`` / ``torch.randint``.

The leading axis of every draw is batch-major (``B``, ``B·T``, ``B·N``,
``B·T·N``), so the rank's rows of the global draw are its clips'.
"""

from __future__ import annotations

import torch


class GlobalBatchGenerator(torch.Generator):
    """A generator of the global batch's random stream on ``device``, of
    which rank ``rank`` of ``world`` keeps its row block."""

    def __new__(cls, device, rank: int, world: int):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} not in [0, {world})")
        self = super().__new__(cls, device)
        self.shard = (int(rank), int(world))
        return self


def _rows(draw, shape, generator):
    shard = getattr(generator, "shard", None)
    if shard is None or shard[1] == 1:
        return draw(tuple(shape))
    r, w = shard
    b = shape[0]
    return draw((b * w, *shape[1:]))[r * b:(r + 1) * b]


def rand(shape, generator: torch.Generator,
         device: torch.device | None = None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator`` (on its device unless
    ``device`` is given), the rank's rows of the global draw."""
    dev = generator.device if device is None else device
    return _rows(lambda s: torch.rand(s, generator=generator, device=dev),
                 shape, generator)


def randint(low: int, high: int, shape, generator: torch.Generator,
            device: torch.device | None = None) -> torch.Tensor:
    """``torch.randint(low, high, shape)`` from ``generator``, the rank's
    rows of the global draw."""
    dev = generator.device if device is None else device
    return _rows(lambda s: torch.randint(low, high, s, generator=generator,
                                         device=dev), shape, generator)
