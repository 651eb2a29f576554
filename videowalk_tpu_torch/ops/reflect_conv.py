"""Which reflect-padded convolutions route to the reflect-conv kernels
(counterpart of ``videowalk_tpu/ops/reflect_conv.py::rconv_kernel_routes``).

The JAX package reads its gates from the environment (``VIDEOWALK_RCONV``,
``VIDEOWALK_RCONV_MIN_C``, ``_ALLOW16``, ``_ALLOW32``); here the mode is an
argument and the shape thresholds are the JAX defaults, fixed until an A/B
on the card needs to move them. Its ``jax.default_backend() == "tpu"``
term becomes "any device": the tensor's device then picks the CUDA kernel
or its plain PyTorch version (``ops/rconv.py``). The XLA-only rewrites of
that module (the strip and ring-dots modes, the CPU im2col lowering) are
not ported: an unrouted reflect conv is ``F.pad(mode="reflect")`` +
``conv2d``.
"""

from __future__ import annotations

from videowalk_tpu_torch.ops.rconv import rconv_supported

RCONV_MODES = ("auto", "on", "off")


def check_rconv_mode(mode: str) -> None:
    if mode not in RCONV_MODES:
        raise ValueError(f"rconv={mode!r}: want auto | on | off")


def rconv_kernel_routes(H: int, W: int, C: int, features: int,
                        mode: str = "auto", kernel: int = 3, stride: int = 1,
                        pad: int = 1) -> bool:
    """True iff a reflect conv of this geometry (input ``H x W x C``,
    ``features`` outputs) takes the reflect-conv kernels.

    ``off``: never. ``on``: every shape ``rconv_supported`` takes. ``auto``
    (the default): the JAX package's measured shape set at its defaults,
    interior convs (``C == features``) with ``C >= 512`` on 8x8 or 32x32
    maps."""
    check_rconv_mode(mode)
    if mode == "off" or not rconv_supported(H, W, kernel, stride, pad):
        return False
    if mode == "on":
        return True
    return H == W and H in (8, 32) and C >= 512 and C == features
