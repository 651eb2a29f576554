"""``trunk_conv_roofline``: the least time of a training step's trunk
convolutions over the device time of every convolution kernel, whichever
library runs it (the reflect-conv kernels ``ops/csrc/rconv_slab.cu`` and
their BN-moment reductions, or cuDNN), in %.

The least time sums, over every conv of the configuration's trunk
(``--model-type``) at its shapes, forward, dx and dW (no dx for the stem),
each the larger of its multiply-adds over the bf16 peak and its bytes
(each input read once, each output written once, in bf16) over the HBM
rate."""

from harness import flops


def is_conv(name: str) -> bool:
    low = name.lower()
    if "rconv_" in low or "reduce_rows" in low:
        return True
    return any(w in low for w in ("conv", "cudnn", "xmma", "fprop", "dgrad",
                                  "wgrad", "implicit"))


def read(ctx):
    if ctx.trace is None:
        return None
    a = ctx.args
    if ctx.superpixel:
        side, images = a.img_size, a.batch_size * a.clip_len
    else:
        side = int(a.patch_size[0])
        n = (a.img_size - side) // (side // 2) + 1
        images = a.batch_size * a.clip_len * n * n
    device_s = ctx.trace.kernel_s(is_conv) / ctx.window["trace_steps"]
    if device_s <= 0:
        return None
    return 100.0 * flops.trunk_bound_s(side, side, images, a.model_type,
                                       tuple(a.remove_layers)) / device_s
