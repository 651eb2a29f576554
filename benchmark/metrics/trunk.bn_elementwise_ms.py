"""``trunk.bn_elementwise_ms``: device milliseconds a training step of the
elementwise and reduction kernels, which are train-mode BN's f32 passes,
the residual adds and the ReLUs (``models/resnet.py``).

Kernel-name classes as ``chip_smoke.py``'s ``profile_steps`` draws them:
the program's own kernels (walk, SLIC, dilation, reflect conv) and the
library's convolutions and optimizer are other classes."""

import re


def kind(name: str) -> str:
    low = name.lower()
    if re.search(r"(^|::)walk_", low):
        return "walk"
    if "slic_" in low or "dilate_l1" in low:
        return "superpixel"
    if "rconv_" in low or "reduce_rows" in low:
        return "reflect conv"
    if any(w in low for w in ("conv", "cudnn", "xmma", "gemm", "dgrad",
                              "wgrad", "implicit")):
        return "convolution"
    if "adam" in low or "foreach" in low or "multi_tensor" in low:
        return "optimizer"
    if "reduce" in low:
        return "reduction"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_s(lambda n: kind(n) in ("elementwise", "reduction"))
    return 1e3 * s / ctx.window["trace_steps"] if s > 0 else None
