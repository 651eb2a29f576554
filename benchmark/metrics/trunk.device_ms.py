"""``trunk.device_ms``: device milliseconds a training step in the
program's ``trunk`` and ``trunk.backward`` spans (the encoder's forward,
and its backward from the gradient of its maps to the last parameter
gradient, remat's recompute included), from their CUDA events, over the
``step`` spans of the traced stretches."""

from harness import spans


def read(ctx):
    return spans.per_root(ctx, "step", ("trunk", "trunk.backward"),
                          "device_ms")
