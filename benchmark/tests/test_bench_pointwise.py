"""``trunk.pointwise_ms`` and ``pointwise_conv_roofline``, which read the
program's ``pointwise`` spans (a Bottleneck's 1x1 convs): each fed a
hand-built recorder summary; no reading without a trace, with a span
short of one a 1x1 conv a step, from a program without those spans, or
in a superpixel cell; and the 1x1 convs the roofline counts."""

import types

import pytest

from harness import common, flops

STEPS = 6


def _ctx(trace=True, model_type="scratch50"):
    args = types.SimpleNamespace(img_size=256, patch_size=[64, 64, 3],
                                 batch_size=8, clip_len=8,
                                 model_type=model_type, remove_layers=[])
    return types.SimpleNamespace(trace=object() if trace else None,
                                 args=args, superpixel=False)


def _read(name, ctx):
    return common.load_module("metrics", name).read(ctx)


def _span(n, device_ms):
    return dict(n=n, host_ms=1.0, device_ms=device_ms, self_host_ms=1.0,
                self_device_ms=device_ms, counts={})


def _summary(per_step=36):
    return {"step": _span(STEPS, STEPS * 150.0),
            "trunk": _span(STEPS, STEPS * 50.0),
            "pointwise": _span(per_step * STEPS, STEPS * 15.0),
            "trunk.backward": _span(STEPS, STEPS * 95.0),
            "pointwise.backward": _span(per_step * STEPS, STEPS * 30.0)}


@pytest.fixture
def recorder(monkeypatch):
    from videowalk_tpu_torch.utils import profile

    box = {"summary": _summary()}
    monkeypatch.setattr(profile, "summary", lambda: box["summary"])
    return box


def test_one_by_one_convs_of_each_trunk():
    for model_type, n in (("scratch50", 36), ("scratch", 3)):
        convs = [c for c in flops.trunk_convs(64, 64, model_type)
                 if c["k"] == 1]
        assert len(convs) == n
        assert all(c["name"].endswith(("conv1", "conv3", "downsample"))
                   for c in convs)
    r50 = [c["name"] for c in flops.trunk_convs(64, 64, "scratch50")
           if c["k"] == 1]
    assert sum(x.endswith("downsample") for x in r50) == 4


def test_readings_with_36_spans_a_step(recorder):
    ctx = _ctx()
    assert _read("trunk.pointwise_ms", ctx) == pytest.approx(45.0)
    convs = [c for c in flops.trunk_convs(64, 64, "scratch50")
             if c["k"] == 1]
    bound_s = sum(flops.conv_bound_s(c, 8 * 8 * 49) for c in convs)
    assert bound_s * 1e3 == pytest.approx(21.22, abs=0.01)
    roof = _read("pointwise_conv_roofline", ctx)
    assert roof == pytest.approx(100.0 * bound_s / 45e-3)
    assert 0.0 < roof <= 100.0


@pytest.mark.parametrize("per_step", [35, 37])
def test_no_roofline_unless_every_conv_was_spanned(recorder, per_step):
    recorder["summary"] = _summary(per_step)
    assert _read("pointwise_conv_roofline", _ctx()) is None
    recorder["summary"] = _summary()
    recorder["summary"]["pointwise.backward"]["n"] -= 1
    assert _read("pointwise_conv_roofline", _ctx()) is None


@pytest.mark.parametrize("name", ["trunk.pointwise_ms",
                                  "pointwise_conv_roofline"])
def test_no_reading_without_a_trace(recorder, name):
    assert _read(name, _ctx(trace=False)) is None


@pytest.mark.parametrize("name", ["trunk.pointwise_ms",
                                  "pointwise_conv_roofline"])
def test_no_reading_from_a_program_without_the_spans(recorder, name):
    """A program from before the spans records no ``pointwise``; a
    ResNet-18 trunk has 3 1x1 convs, not the 36 spans a step."""
    for missing in ("pointwise", "pointwise.backward"):
        recorder["summary"] = _summary()
        del recorder["summary"][missing]
        assert _read(name, _ctx()) is None
    recorder["summary"] = _summary()
    assert _read("pointwise_conv_roofline",
                 _ctx(model_type="scratch")) is None


def test_no_roofline_in_a_superpixel_cell(recorder):
    ctx = _ctx()
    ctx.superpixel = True
    assert _read("pointwise_conv_roofline", ctx) is None


def test_no_reading_without_the_program_recorder(monkeypatch):
    from videowalk_tpu_torch.utils import profile

    monkeypatch.delattr(profile, "summary")
    for name in ("trunk.pointwise_ms", "pointwise_conv_roofline"):
        assert _read(name, _ctx()) is None

