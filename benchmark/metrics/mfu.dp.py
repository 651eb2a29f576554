"""``mfu.dp``: ``mfu.train`` of a cell on one process a card, which moves
``dp_clips_per_s``: the global batch's conv FLOPs over the window's time,
over the cards' summed bf16 peak."""

from harness import common


def read(ctx):
    return common.load_module("metrics", "mfu.train").read(ctx)
