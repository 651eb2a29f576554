"""The yardstick's arithmetic: the card's peaks, the trunk's convolutions
at a configuration's shapes, and propagation's work per target.

Copied, not imported, from the program's own measurement scripts
(``bench.py:140-154``'s conv count, ``chip_smoke.py``'s ``rconv_bounds``
and ``ops/prop_sparse.py``'s ``valid_pairs``) and its table of trunks
(``models/encoder.py:_TRUNKS``, ``models/resnet.py``), so that the
yardstick does not move when the program does."""

from __future__ import annotations

import numpy as np

# one NVIDIA H100 SXM (data sheet, dense, at 700 W)
BF16_PEAK = 989e12
FP32_PEAK = 67e12
HBM_RATE = 3.35e12

STAGES = (("layer1", 64, 1), ("layer2", 128, 2), ("layer3", 256, 1),
          ("layer4", 512, 1))
RESNET18 = ((2, 2, 2, 2), False)     # BasicBlocks
RESNET50 = ((3, 4, 6, 3), True)      # Bottlenecks, expansion 4
# --model-type -> (blocks a stage, Bottleneck); the padding (reflect or
# zeros) leaves every shape as it is
TRUNKS = {"scratch": RESNET18, "scratch_zeropad": RESNET18,
          "imagenet18": RESNET18, "uvc": RESNET18, "scratch50": RESNET50,
          "imagenet50": RESNET50, "moco50": RESNET50, "timecycle": RESNET50}


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def trunk_convs(h: int, w: int, model_type: str,
                remove_layers=()) -> list[dict]:
    """Every convolution of ``model_type``'s modified ResNet (stride-1
    layer3/4; a Bottleneck's stride on its 3x3) on one ``h x w`` image:
    ``cin, cout, k, stride`` and the input and output sizes."""
    if model_type not in TRUNKS:
        raise ValueError(f"no trunk for --model-type {model_type!r}")
    sizes, bottleneck = TRUNKS[model_type]
    convs = []

    def add(name, cin, cout, k, s, p, hi, wi):
        ho, wo = _out(hi, k, s, p), _out(wi, k, s, p)
        convs.append(dict(name=name, cin=cin, cout=cout, k=k, stride=s,
                          h_in=hi, w_in=wi, h_out=ho, w_out=wo))
        return ho, wo

    h, w = add("conv1", 3, 64, 7, 2, 3, h, w)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)           # max pool 3/2
    cin = 64
    for (stage, width, stride), n_blocks in zip(STAGES, sizes):
        if stage in remove_layers:
            continue
        for b in range(n_blocks):
            s, q = stride if b == 0 else 1, f"{stage}.{b}."
            if bottleneck:
                cout = 4 * width
                add(q + "conv1", cin, width, 1, 1, 0, h, w)
                h1, w1 = add(q + "conv2", width, width, 3, s, 1, h, w)
                add(q + "conv3", width, cout, 1, 1, 0, h1, w1)
            else:
                cout = width
                h1, w1 = add(q + "conv1", cin, width, 3, s, 1, h, w)
                add(q + "conv2", width, width, 3, 1, 1, h1, w1)
            if s != 1 or cin != cout:
                add(q + "downsample", cin, cout, 1, s, 0, h, w)
            cin, h, w = cout, h1, w1
    return convs


def conv_flops(c: dict) -> int:
    """Forward multiply-adds of one conv on one image, counted twice."""
    return 2 * c["h_out"] * c["w_out"] * c["k"] ** 2 * c["cin"] * c["cout"]


def conv_fwd_flops_per_image(h: int, w: int, model_type: str,
                             remove_layers=()) -> int:
    return sum(conv_flops(c)
               for c in trunk_convs(h, w, model_type, remove_layers))


def conv_bound_s(c: dict, images: int, passes=("fwd", "dx", "dw")) -> float:
    """The least time of the conv's ``passes`` over ``images`` images in
    bf16: for each, the larger of its multiply-adds over the bf16 peak and
    its bytes over the HBM rate, each input read once and each output
    written once."""
    flops = conv_flops(c) * images
    x = images * c["cin"] * c["h_in"] * c["w_in"] * 2
    y = images * c["cout"] * c["h_out"] * c["w_out"] * 2
    wb = c["k"] ** 2 * c["cin"] * c["cout"] * 2
    nbytes = dict(fwd=x + wb + y, dx=y + wb + x, dw=x + y + wb)
    return sum(max(flops / BF16_PEAK, nbytes[p] / HBM_RATE) for p in passes)


def trunk_bound_s(h: int, w: int, images: int, model_type: str,
                  remove_layers=()) -> float:
    """Least time of a training step's trunk convolutions: forward, dx
    and dW of each, but the stem's dx (its input needs no gradient)."""
    total = 0.0
    for c in trunk_convs(h, w, model_type, remove_layers):
        passes = ("fwd", "dw") if c["name"] == "conv1" else ("fwd", "dx", "dw")
        total += conv_bound_s(c, images, passes=passes)
    return total


def valid_pairs(H: int, W: int, radius: float, n_long: int,
                n_short: int) -> int:
    """(query, candidate) pairs one target needs: every cell of each long
    frame, and per short frame the in-frame cells of each query's disk
    ``dy^2 + dx^2 < radius^2``."""
    rr = max(int(np.ceil(radius)) - 1, 0)
    d = np.arange(-rr, rr + 1)
    dy, dx = np.meshgrid(d, d, indexing="ij")
    disk = (dy * dy + dx * dx).astype(np.float32) < np.float32(radius * radius)
    per = np.maximum(H - np.abs(dy), 0) * np.maximum(W - np.abs(dx), 0)
    return int(n_long * (H * W) ** 2 + n_short * per[disk].sum())


def prop_flops_per_target(H: int, W: int, C: int, n_labels: int, *,
                          radius: float, n_long: int, n_short: int,
                          topk: int) -> int:
    """f32 operations one target needs: a C-long dot product (2C) and a
    top-k comparison (1) a valid pair, then per query the softmax of its
    top-k (2 a kept logit) and the weighted label sum (2 a label)."""
    pairs = valid_pairs(H, W, radius, n_long, n_short)
    return pairs * (2 * C + 1) + H * W * topk * (2 + 2 * n_labels)
