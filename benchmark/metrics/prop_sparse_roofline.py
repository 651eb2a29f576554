"""``prop_sparse_roofline``: the least f32 time of the propagation work a
target needs over the device time of the block-sparse kernel
(``ops/csrc/prop_sparse.cu``, one launch a target) in the traced video,
in %.

The work counts each query cell against every cell of the long-term
frames and against the cells within ``radius`` of it in each short-term
frame (a dot product over C and a top-k comparison a pair), then the
top-k softmax and the label sum; not the kernel's own union of its tile's
disks. Over 67 TFLOP/s (f32 without the tensor cores)."""

import math

from harness import flops


def read(ctx):
    if ctx.trace is None:
        return None
    a = ctx.args
    kern = [e for e in ctx.trace.kernels if "prop_sparse" in e["name"]]
    if not kern:
        return None
    _, _, n_labels = ctx.window["trace_run"]
    H, W = math.ceil(ctx.height / 8), math.ceil(ctx.width / 8)
    work = flops.prop_flops_per_target(
        H, W, ctx.channels, n_labels, radius=a.radius,
        n_long=len(a.long_mem), n_short=a.videoLen, topk=a.topk)
    device_s = sum(e["dur"] for e in kern) * 1e-6
    return 100.0 * len(kern) * work / flops.FP32_PEAK / device_s
