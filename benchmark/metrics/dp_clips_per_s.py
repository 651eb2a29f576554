"""``dp_clips_per_s``: ``train_clips_per_s`` of a cell on one process a
card: every clip of the global batch stepped in the window over the
window's wall time on rank 0's clock (the window holds the ranks'
agreement on that clock at each step that fetches the loss). A name of its own, since its runs
spread more (0.3–0.5%, the ranks waiting for the slowest at every
collective) than the one-card rate's 1% bound can hold."""

from harness import common


def read(ctx):
    return common.load_module("metrics", "train_clips_per_s").read(ctx)
