"""``trunk.device_ms.dp``: ``trunk.device_ms`` of a cell on one process a
card, which moves ``dp_clips_per_s``: rank 0's trunk spans a step, BN's
moment all-reduces inside them."""

from harness import common


def read(ctx):
    return common.load_module("metrics", "trunk.device_ms").read(ctx)
