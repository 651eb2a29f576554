"""``benchmark/metrics/trunk.bn_fused_share.py``: the share of the trunk's
BN applications on the BN kernels, from the ``bn_fused`` and ``bn_plain``
counts of the program's ``trunk`` and ``trunk.backward`` spans; no reading
without a trace, without the counts (a program from before them) or
without a recorder."""

import types

import pytest

from harness import common


def _ctx(trace=True):
    return types.SimpleNamespace(trace=object() if trace else None)


def _read(ctx):
    return common.load_module("metrics", "trunk.bn_fused_share").read(ctx)


def _summary(fwd: dict, bwd: dict) -> dict:
    def span(counts):
        return dict(n=4, host_ms=1.0, device_ms=1.0, self_host_ms=1.0,
                    self_device_ms=1.0, counts=counts)

    return {"step": span({}), "trunk": span(fwd), "trunk.backward": span(bwd)}


@pytest.mark.parametrize("fwd,bwd,share", [
    ({"bn_fused": 160}, {"bn_fused": 16}, 100.0),
    ({"bn_fused": 120, "bn_plain": 40}, {}, 75.0),
    ({"bn_plain": 160}, {"bn_plain": 16}, 0.0),
])
def test_share_of_the_counts(monkeypatch, fwd, bwd, share):
    from videowalk_tpu_torch.utils import profile

    monkeypatch.setattr(profile, "summary", lambda: _summary(fwd, bwd))
    assert _read(_ctx()) == pytest.approx(share)
    assert _read(_ctx(trace=False)) is None


def test_no_reading_without_the_counts_or_the_recorder(monkeypatch):
    from videowalk_tpu_torch.utils import profile

    monkeypatch.setattr(profile, "summary", lambda: _summary({}, {}))
    assert _read(_ctx()) is None
    monkeypatch.delattr(profile, "summary")
    assert _read(_ctx()) is None


def test_reads_the_program_trunk_on_the_cpu():
    """The program's own counts: a small trunk's train step on the CPU
    takes the eager chain, so the share is 0."""
    import torch

    from videowalk_tpu_torch.models.resnet import resnet18
    from videowalk_tpu_torch.utils import profile

    trunk = resnet18("reflect", remove_layers=("layer3", "layer4"))
    x = torch.randn((2, 3, 32, 32))
    profile.reset()
    profile.enable()
    try:
        with profile.span("step", root=True):
            with profile.span("trunk"):
                out = trunk(x, train=True)
            out.sum().backward()
        assert _read(_ctx()) == 0.0
    finally:
        profile.disable()
        profile.reset()
