"""``mfu.eval``: the evaluator's FLOPs over the window, as a share of the
card's f32 peak (67 TFLOP/s: the encoder runs in f32 with TF32 off,
``cli/test.py::encode_video``, and propagation in f32 FMAs).

FLOPs: the trunk's forward convolutions (the configuration's
``--model-type`` and ``--remove-layers``) on every frame encoded (the
``videoLen`` copies of frame 0 included), and propagation's work on every
target as ``prop_sparse_roofline`` counts it. Frames and seconds are the
window's, less the traced video."""

import math

from harness import flops


def read(ctx):
    a, w = ctx.args, ctx.window
    seconds = w.get("untraced_wall_s", w["wall_s"])
    if not w["runs"] or seconds <= 0:
        return None
    enc = flops.conv_fwd_flops_per_image(ctx.height, ctx.width,
                                         a.model_type, tuple(a.remove_layers))
    H, W = math.ceil(ctx.height / 8), math.ceil(ctx.width / 8)
    total = 0
    for frames, targets, n_labels in w["runs"]:
        total += frames * enc + targets * flops.prop_flops_per_target(
            H, W, ctx.channels, n_labels, radius=a.radius,
            n_long=len(a.long_mem), n_short=a.videoLen, topk=a.topk)
    return 100.0 * total / seconds / flops.FP32_PEAK
