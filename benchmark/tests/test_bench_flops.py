"""The yardstick's arithmetic pinned to its sources: ``bench.py:140-154``'s
conv count (14.15 TFLOP a flagship step), ``chip_smoke.py``'s
``rconv_bounds`` (0.96 ms at 3136 x 8x8, 512 -> 512), propagation's
pairs at DAVIS-480p against a brute-force count, and 43.2 GFLOP a
480x854 encode."""

import numpy as np
import pytest

from harness import flops


def bench_conv_fwd_flops_per_image() -> int:
    """``bench.py:140-154``, as written there."""
    f = 2 * 32 * 32 * 49 * 3 * 64
    f += 4 * 2 * 16 * 16 * 9 * 64 * 64
    f += (2 * 8 * 8 * 9 * 64 * 128 + 2 * 8 * 8 * 64 * 128
          + 3 * 2 * 8 * 8 * 9 * 128 * 128)
    f += (2 * 8 * 8 * 9 * 128 * 256 + 2 * 8 * 8 * 128 * 256
          + 3 * 2 * 8 * 8 * 9 * 256 * 256)
    f += (2 * 8 * 8 * 9 * 256 * 512 + 2 * 8 * 8 * 256 * 512
          + 3 * 2 * 8 * 8 * 9 * 512 * 512)
    return f


def test_flagship_step_flops():
    per_image = flops.conv_fwd_flops_per_image(64, 64)
    assert per_image == bench_conv_fwd_flops_per_image()
    step = 3 * per_image * 8 * 8 * 49
    assert round(step / 1e12, 2) == 14.15


def test_mfu_clip_flops_matches_step():
    import types

    from harness import common

    mfu = common.load_module("metrics", "mfu.train")
    args = types.SimpleNamespace(img_size=256, patch_size=[64, 64, 3],
                                 clip_len=8)
    assert 8 * mfu.clip_flops(args, False) == 3 * 1504051200 * 8 * 8 * 49
    assert round(6 * mfu.clip_flops(args.__class__(
        img_size=256, patch_size=[64], clip_len=4), True) / 1e12, 2) == 1.73


@pytest.mark.parametrize("name,cin,cout", [("layer4.1.conv2", 512, 512),
                                           ("layer3.1.conv2", 256, 256)])
def test_rconv_bound(name, cin, cout):
    conv = next(c for c in flops.resnet18_convs(64, 64) if c["name"] == name)
    assert (conv["cin"], conv["cout"], conv["h_out"]) == (cin, cout, 8)
    fwd = flops.conv_bound_s(conv, 3136, passes=("fwd",))
    # chip_smoke.py's rconv_bounds: 2 M 9 Cin Cout over the bf16 peak
    M = 3136 * 8 * 8
    assert fwd == pytest.approx(2 * M * 9 * cin * cout / 989e12)
    if cin == 512:
        assert round(fwd * 1e3, 2) == 0.96


def brute_pairs(H, W, radius, n_long, n_short):
    n = 0
    for y in range(H):
        for x in range(W):
            n += n_long * H * W
            for yy in range(H):
                for xx in range(W):
                    d2 = np.float32((y - yy) ** 2 + (x - xx) ** 2)
                    n += n_short * int(d2 < np.float32(radius * radius))
    return n


@pytest.mark.parametrize("H,W,radius", [(6, 9, 3.0), (8, 5, 2.5),
                                        (7, 7, 12.0)])
def test_valid_pairs_brute_force(H, W, radius):
    assert flops.valid_pairs(H, W, radius, 1, 4) == brute_pairs(
        H, W, radius, 1, 4)


def test_prop_bound_davis():
    from videowalk_tpu_torch.ops.prop_sparse import valid_pairs

    pairs = flops.valid_pairs(60, 107, 12.0, 1, 20)
    assert pairs == valid_pairs(60, 107, 12.0, 1, 20) == 90214480
    work = flops.prop_flops_per_target(60, 107, 256, 3, radius=12.0,
                                       n_long=1, n_short=20, topk=10)
    assert round(work / flops.FP32_PEAK * 1e3, 2) == 0.69


def test_encode_flops_davis():
    f = flops.conv_fwd_flops_per_image(480, 854, ("layer4",))
    assert round(f / 1e9, 1) == 43.2
    convs = flops.resnet18_convs(480, 854, ("layer4",))
    assert (convs[-1]["h_out"], convs[-1]["w_out"]) == (60, 107)
