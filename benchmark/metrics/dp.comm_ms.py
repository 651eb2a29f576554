"""``dp.comm_ms``: device milliseconds a training step in the program's
``dp.all_reduce`` spans (``parallel/mesh.py``: train-mode BN's moments,
forward and backward, and the one flat all-reduce of the gradients),
from their CUDA events on the step's stream, which waits for each
collective, over the ``step`` spans of the traced rank's traced
stretches."""

from harness import spans


def read(ctx):
    return spans.per_root(ctx, "step", ("dp.all_reduce",), "device_ms")
