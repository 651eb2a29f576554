"""``pointwise_conv_roofline``: the least time of a patch training step's
1x1 convolutions over the device time of the program's ``pointwise`` and
``pointwise.backward`` spans a step (``trunk.pointwise_ms``), in %.

The least time sums, over every 1x1 conv of the configuration's trunk
(``--model-type``; a Bottleneck's ``conv1`` and ``conv3`` and each
projection) at its shapes, forward, dx and dW, each through
``flops.conv_bound_s`` in bf16. No reading unless each of the two spans
ran once a 1x1 conv a step: a span that missed a conv would leave its
work out of the time and read high."""

from harness import flops, spans

NAMES = ("pointwise", "pointwise.backward")


def pointwise_convs(args) -> tuple[list, int]:
    """The trunk's 1x1 convs on one patch, and the patches a step."""
    side = int(args.patch_size[0])
    n = (args.img_size - side) // (side // 2) + 1
    convs = flops.trunk_convs(side, side, args.model_type,
                              tuple(args.remove_layers))
    return ([c for c in convs if c["k"] == 1],
            args.batch_size * args.clip_len * n * n)


def read(ctx):
    if ctx.trace is None or ctx.superpixel:
        return None
    convs, images = pointwise_convs(ctx.args)
    summary = spans.summary()
    if not summary:
        return None
    steps = summary.get("step", {}).get("n")
    if not steps or any(summary.get(name, {}).get("n") != len(convs) * steps
                        for name in NAMES):
        return None
    device_ms = spans.per_root(ctx, "step", NAMES, "device_ms")
    if not device_ms:
        return None
    bound_s = sum(flops.conv_bound_s(c, images) for c in convs)
    return 100.0 * bound_s / (device_ms * 1e-3)
