"""``mfu.train``: the training step's model FLOPs over the window, as a
share of the cards' bf16 peak (989 TFLOP/s a chip, times the cell's
chips).

FLOPs as ``bench.py:140-154`` counts them: the trunk's convolutions
(the configuration's ``--model-type``), three times their forward
(forward, dx, dW), on every image of every clip of the global batch
stepped; no recompute, head or walk. Clips and seconds are the window's,
less the traced stretch."""

from harness import flops


def clip_flops(args, superpixel: bool) -> int:
    removed = tuple(args.remove_layers)
    if superpixel:
        per_image = flops.conv_fwd_flops_per_image(
            args.img_size, args.img_size, args.model_type, removed)
        return 3 * per_image * args.clip_len
    p = int(args.patch_size[0])
    n_side = (args.img_size - p) // (p // 2) + 1
    per_image = flops.conv_fwd_flops_per_image(p, p, args.model_type, removed)
    return 3 * per_image * args.clip_len * n_side * n_side


def read(ctx):
    w = ctx.window
    seconds = w.get("untraced_wall_s", w["wall_s"])
    if w["clips"] <= 0 or seconds <= 0:
        return None
    rate = w["clips"] / seconds * clip_flops(ctx.args, ctx.superpixel)
    return 100.0 * rate / (flops.BF16_PEAK * ctx.chips)
