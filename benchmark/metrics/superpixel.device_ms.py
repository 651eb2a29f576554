"""``superpixel.device_ms``: device milliseconds a training step of the
superpixel layer: SLIC's kernels (``ops/csrc/slic.cu``, by name) and every
kernel launched inside ``models/crw.py::superpixel_pool_weights`` (the
one-hot masks, the L1 dilation ``ops/csrc/dilation.cu`` and the window
sums), which the benchmark wraps in its span ``bench.sp_pool`` during the
traced stretch."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = (ctx.trace.kernel_s(lambda n: "slic_" in n.lower())
         + ctx.trace.kernel_s_in_spans("bench.sp_pool"))
    return 1e3 * s / ctx.window["trace_steps"] if s > 0 else None
