"""``eval.dump_ms_per_video``: host milliseconds a video in the program's
``dump`` span (``cli/test.py::_test_video``: each target's prediction
through the dump and its writer pool, to the video's end; the card idles
in it), over the ``video`` spans of the traced runs."""

from harness import spans


def read(ctx):
    return spans.per_root(ctx, "video", ("dump",), "host_ms")
