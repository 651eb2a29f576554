"""``nodes.device_ms``: device milliseconds a training step in the
program's ``nodes`` and ``nodes.backward`` spans (featdrop, the patch
mean-pool or the superpixel weights and segment pooling, the head and the
L2 norm, forward and backward), from their CUDA events, over the ``step``
spans of the traced stretches."""

from harness import spans


def read(ctx):
    return spans.per_root(ctx, "step", ("nodes", "nodes.backward"),
                          "device_ms")
