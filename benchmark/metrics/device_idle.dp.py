"""``device_idle.dp``: ``device_idle.train`` of a cell on one process a
card, which moves ``dp_clips_per_s``: rank 0's idle share in its stretch
profiled without host operators (a wait for another rank inside a
collective counts as busy: NCCL's kernel runs)."""

from harness import common


def read(ctx):
    return common.load_module("metrics", "device_idle.train").read(ctx)
