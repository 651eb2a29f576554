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
    per_image = flops.conv_fwd_flops_per_image(64, 64, "scratch")
    assert per_image == bench_conv_fwd_flops_per_image()
    step = 3 * per_image * 8 * 8 * 49
    assert round(step / 1e12, 2) == 14.15


def test_mfu_clip_flops_matches_step():
    import types

    from harness import common

    mfu = common.load_module("metrics", "mfu.train")
    args = types.SimpleNamespace(img_size=256, patch_size=[64, 64, 3],
                                 clip_len=8, model_type="scratch",
                                 remove_layers=[])
    assert 8 * mfu.clip_flops(args, False) == 3 * 1504051200 * 8 * 8 * 49
    assert round(6 * mfu.clip_flops(args.__class__(
        img_size=256, patch_size=[64], clip_len=4, model_type="scratch",
        remove_layers=[]), True) / 1e12, 2) == 1.73


@pytest.mark.parametrize("name,cin,cout", [("layer4.1.conv2", 512, 512),
                                           ("layer3.1.conv2", 256, 256)])
def test_rconv_bound(name, cin, cout):
    conv = next(c for c in flops.trunk_convs(64, 64, "scratch")
                if c["name"] == name)
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
    f = flops.conv_fwd_flops_per_image(480, 854, "scratch", ("layer4",))
    assert round(f / 1e9, 1) == 43.2
    convs = flops.trunk_convs(480, 854, "scratch", ("layer4",))
    assert (convs[-1]["h_out"], convs[-1]["w_out"]) == (60, 107)


@pytest.mark.parametrize("h,w,removed,n_convs,fwd", [
    (64, 64, (), 20, 1_504_051_200),
    (256, 256, (), 20, 24_064_819_200),
    (480, 854, ("layer4",), 15, 43_160_893_440)])
def test_resnet18_inventory_is_pinned(h, w, removed, n_convs, fwd):
    for model_type in ("scratch", "scratch_zeropad", "imagenet18", "uvc"):
        assert len(flops.trunk_convs(h, w, model_type, removed)) == n_convs
        assert flops.conv_fwd_flops_per_image(h, w, model_type,
                                              removed) == fwd


@pytest.mark.parametrize("side,images,bound", [(64, 12544, 0.0592990),
                                               (256, 640, 0.0484075)])
def test_resnet18_trunk_bound_is_pinned(side, images, bound):
    """The patch step's 32 x 8 x 49 images and sp's 160 x 4."""
    assert flops.trunk_bound_s(side, side, images, "scratch") == \
        pytest.approx(bound, abs=5e-8)


def hooked_convs(model_type, h, w, removed):
    """Every ``PadConv2d`` the port's trunk runs on one ``h x w`` image, in
    order: ``(cin, cout, k, stride, h_out, w_out)``, and their
    forward FLOPs, read by forward hooks."""
    import torch

    from videowalk_tpu_torch.models.encoder import make_encoder
    from videowalk_tpu_torch.models.resnet import PadConv2d

    trunk = make_encoder(model_type, removed).module.model
    seen = []

    def hook(m, inputs, out):
        seen.append((m.in_channels, m.out_channels, m.kernel_size[0],
                     m.stride[0], out.shape[2], out.shape[3]))

    for m in trunk.modules():
        if isinstance(m, PadConv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        trunk(torch.zeros(1, 3, h, w), False)
    fwd = sum(2 * ho * wo * k * k * cin * cout
              for cin, cout, k, _, ho, wo in seen)
    return seen, fwd


@pytest.mark.parametrize("h,w,removed,n_convs,fwd", [
    (64, 64, (), 53, 3_114_663_936),
    (256, 256, (), 53, 49_834_622_976),
    (480, 854, ("layer4",), 43, 120_577_259_520)])
def test_resnet50_inventory_matches_the_port(h, w, removed, n_convs, fwd):
    seen, port_fwd = hooked_convs("scratch50", h, w, removed)
    ours = flops.trunk_convs(h, w, "scratch50", removed)
    assert [(c["cin"], c["cout"], c["k"], c["stride"], c["h_out"],
             c["w_out"]) for c in ours] == seen
    assert len(ours) == n_convs
    assert flops.conv_fwd_flops_per_image(h, w, "scratch50", removed) == \
        port_fwd == fwd
    for model_type in ("imagenet50", "moco50", "timecycle"):
        assert flops.conv_fwd_flops_per_image(h, w, model_type,
                                              removed) == fwd


def test_unknown_trunk_is_refused():
    with pytest.raises(ValueError):
        flops.trunk_convs(64, 64, "resnet101")


def test_mfu_peak_is_the_cards():
    """``mfu.train`` over ``chips`` times the bf16 peak: the same clips a
    second over four cards read a quarter of one card's share."""
    import types

    from harness import common

    mfu = common.load_module("metrics", "mfu.train")
    args = types.SimpleNamespace(img_size=256, patch_size=[64, 64, 3],
                                 clip_len=8, model_type="scratch",
                                 remove_layers=[])

    def ctx(chips):
        return types.SimpleNamespace(
            args=args, superpixel=False, chips=chips,
            window=dict(clips=1280, wall_s=10.0))

    one = mfu.read(ctx(1))
    assert one == pytest.approx(
        100 * 128 * mfu.clip_flops(args, False) / 989e12)
    assert mfu.read(ctx(4)) == pytest.approx(one / 4)
