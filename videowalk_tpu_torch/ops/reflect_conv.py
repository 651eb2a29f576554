"""Which reflect-padded convolutions route to the reflect-conv kernels
(counterpart of ``videowalk_tpu/ops/reflect_conv.py::rconv_kernel_routes``).

The JAX package reads its gates from the environment (``VIDEOWALK_RCONV``,
``VIDEOWALK_RCONV_MIN_C``, ``_ALLOW16``, ``_ALLOW32``) and its ``auto`` is
a shape set measured on a TPU; here the mode is an argument, ``on`` and
``off`` mean what they mean there, and ``auto`` is the set the H100 chose
(``rconv_kernel_routes``). Its ``jax.default_backend() == "tpu"`` term
becomes "any device": the tensor's device then picks the CUDA kernel or its
plain PyTorch version (``ops/rconv.py``). The XLA-only rewrites of that
module (the strip and ring-dots modes, the CPU im2col lowering) are not
ported: an unrouted reflect conv is ``F.pad(mode="reflect")`` + ``conv2d``.
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
    ``features`` outputs) takes the reflect-conv kernels (``C`` and
    ``features`` keep the JAX signature; no route reads them today).

    ``off``: never. ``on``: every shape ``rconv_supported`` takes. ``auto``
    (the default): the shapes where the kernels won on the H100, which today
    are every shape ``rconv_supported`` takes. The same-process A/B of the
    training steps (``PERF.md`` §5: the flagship step fastest with every
    supported conv routed and the BN-input chain, the superpixel step's
    device time lowest) and the kernel-against-library times at the six
    shapes ``chip_smoke.py`` checks (each kernel's forward and backward
    under cuDNN's) left no shape out. A shape that loses there is taken out
    of ``auto`` here."""
    check_rconv_mode(mode)
    return mode != "off" and rconv_supported(H, W, kernel, stride, pad)
