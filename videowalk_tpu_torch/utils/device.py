"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a missing
card is an error, never a silent fallback to the CPU.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``name`` ('cuda', 'cuda:1', 'cpu' or a ``torch.device``) ->
    ``torch.device``. Raises if a CUDA device is asked for and none is
    available."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass --device cpu to run on the CPU")
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matrix products in full f32 inside the block, whatever the caller
    set: ``torch.backends.cuda.matmul.allow_tf32`` is turned off and put
    back. For sums whose terms nearly cancel or must stay exact (segment
    pooling weights, SLIC's expanded distances)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
