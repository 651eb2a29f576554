"""``eval.labels_ms_per_video``: host milliseconds a video in the
program's ``labels`` span (``cli/test.py::_test_video``: from the encode's
synchronize, the label buffer made and copied to the card, up to the
first propagation launch; the card idles in it), over the ``video`` spans
of the traced runs."""

from harness import spans


def read(ctx):
    return spans.per_root(ctx, "video", ("labels",), "host_ms")
