"""``trunk.pointwise_ms``: device milliseconds a training step in the
program's ``pointwise`` and ``pointwise.backward`` spans (a Bottleneck's
1x1 convolutions, ``conv1``, ``conv3`` and the projection's
``downsample.0``, forward and their dx and dW), from their CUDA events,
over the ``step`` spans of the traced stretches. A trunk without such
spans gives no reading."""

from harness import spans


def read(ctx):
    return spans.per_root(ctx, "step", ("pointwise", "pointwise.backward"),
                          "device_ms")
