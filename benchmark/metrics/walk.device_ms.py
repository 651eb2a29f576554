"""``walk.device_ms``: device milliseconds a training step in the
program's ``walk`` and ``walk.backward`` spans (the walk loss, fused,
plain or Sinkhorn, forward and backward), from their CUDA events, over the
``step`` spans of the traced stretches."""

from harness import spans


def read(ctx):
    return spans.per_root(ctx, "step", ("walk", "walk.backward"),
                          "device_ms")
