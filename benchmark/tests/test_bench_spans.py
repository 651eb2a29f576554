"""The per-layer metrics that read the program's spans
(``benchmark/metrics/{trunk,nodes,walk}.device_ms.py``, ``dp.comm_ms.py``,
``trunk.device_ms.dp.py``,
``eval.{labels,dump}_ms_per_video.py``): each fed a hand-built recorder
summary, and read from the program's own recorder on the CPU; no reading
without a trace, a root span, or a recorder (a program from before the
recorder)."""

import types

import pytest

from harness import common

TRAIN = ("trunk.device_ms", "nodes.device_ms", "walk.device_ms",
         "dp.comm_ms", "trunk.device_ms.dp")
EVAL = ("eval.labels_ms_per_video", "eval.dump_ms_per_video")


def _ctx(trace=True):
    return types.SimpleNamespace(trace=object() if trace else None)


def _read(name, ctx):
    return common.load_module("metrics", name).read(ctx)


def _span(n, host_ms, device_ms):
    return dict(n=n, host_ms=host_ms, device_ms=device_ms,
                self_host_ms=host_ms, self_device_ms=device_ms, counts={})


HAND = {
    "step": _span(16, 8000.0, 7600.0),
    "trunk": _span(16, 40.0, 2400.0),
    "trunk.backward": _span(16, 60.0, 4800.0),
    "nodes": _span(16, 5.0, 64.0),
    "nodes.backward": _span(16, 3.0, 96.0),
    "walk": _span(16, 2.0, 16.0),
    "walk.backward": _span(16, 2.0, 32.0),
    "dp.all_reduce": _span(16 * 81, 40.0, 56.0),
    "video": _span(2, 1200.0, 1190.0),
    "labels": _span(2, 14.0, 13.0),
    "dump": _span(2, 9.0, 8.5),
}


@pytest.fixture
def hand(monkeypatch):
    from videowalk_tpu_torch.utils import profile

    monkeypatch.setattr(profile, "summary", lambda: HAND)
    return HAND


def test_readers_on_a_hand_built_recorder(hand):
    ctx = _ctx()
    assert _read("trunk.device_ms", ctx) == pytest.approx(7200.0 / 16)
    assert _read("nodes.device_ms", ctx) == pytest.approx(160.0 / 16)
    assert _read("walk.device_ms", ctx) == pytest.approx(48.0 / 16)
    assert _read("dp.comm_ms", ctx) == pytest.approx(56.0 / 16)
    assert _read("trunk.device_ms.dp", ctx) == pytest.approx(7200.0 / 16)
    assert _read("eval.labels_ms_per_video", ctx) == pytest.approx(7.0)
    assert _read("eval.dump_ms_per_video", ctx) == pytest.approx(4.5)


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_no_reading_without_trace_root_or_span(hand, monkeypatch, name):
    assert _read(name, _ctx(trace=False)) is None
    root = "step" if name in TRAIN else "video"
    monkeypatch.setitem(HAND, root, _span(0, 0.0, 0.0))
    assert _read(name, _ctx()) is None
    monkeypatch.delitem(HAND, root)
    assert _read(name, _ctx()) is None


def test_no_reading_without_the_program_recorder(monkeypatch):
    from videowalk_tpu_torch.utils import profile

    monkeypatch.delattr(profile, "summary")
    for name in TRAIN + EVAL:
        assert _read(name, _ctx()) is None


def test_readers_on_the_program_recorder():
    """The program's own spans on the CPU: host times read, device times
    (no CUDA events there) give no reading."""
    from videowalk_tpu_torch.utils import profile

    profile.reset()
    profile.enable()
    try:
        for v in range(2):
            with profile.span("video", root=True, frames=3):
                for phase in ("encode", "labels", "propagate", "dump"):
                    with profile.span(phase):
                        pass
        with profile.span("step", root=True):
            with profile.span("trunk"):
                pass
            with profile.span("trunk.backward"):
                pass
        s = profile.summary()
        assert _read("eval.labels_ms_per_video", _ctx()) == pytest.approx(
            s["labels"]["host_ms"] / 2)
        assert _read("eval.dump_ms_per_video", _ctx()) == pytest.approx(
            s["dump"]["host_ms"] / 2)
        assert _read("trunk.device_ms", _ctx()) is None
    finally:
        profile.disable()
        profile.reset()
