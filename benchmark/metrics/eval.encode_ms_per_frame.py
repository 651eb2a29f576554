"""``eval.encode_ms_per_frame``: the evaluator's own span of the encoder,
``cli/test.py::test``'s ``encode_s`` a video (host clock, ending in a
device synchronize), summed over the window's videos, over the frames
encoded (the ``videoLen`` copies of frame 0 included), in ms."""


def read(ctx):
    w = ctx.window
    return 1e3 * w["encode_s"] / w["frames"] if w["frames"] else None
