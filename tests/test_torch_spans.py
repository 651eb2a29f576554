"""The port's span recorder (``videowalk_tpu_torch/utils/profile.py``) and its
sites: nesting, parents and roots; the off path (no ``record_function``, no
hook, no CUDA event); on under a ``torch.profiler`` session and off after
it; the backward spans of ``trunk``, ``nodes`` and ``walk`` in a CRW step;
a Bottleneck's ``pointwise`` spans (ResNet-50 only; the trunk's outputs
bitwise as without spans); every span a ``user_annotation`` of an exported
trace, nested as recorded; ``test()``'s seconds and ``log_every``'s data
time read from the spans; ``Trace.stop``'s table. The ``-m cuda`` case
checks on the card that the layer spans of a step cover its device time. No
JAX here, so the file runs with ``--noconftest`` where JAX is not
installed."""

import copy
import json
import os
import threading
import time
import types

import pytest
import torch

from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.ops.slic import slic_fused
from videowalk_tpu_torch.parallel import (create_train_state, make_optimizer,
                                          make_train_step)
from videowalk_tpu_torch.utils import profile
from videowalk_tpu_torch.utils.meters import MetricLogger

torch.set_num_threads(1)

LAYERS = ("trunk", "nodes", "walk")


@pytest.fixture
def spans():
    profile.disable()
    profile.reset()
    yield profile
    profile.disable()
    profile.reset()


@pytest.fixture
def log(monkeypatch):
    """Each span's opening and closing, in order: ``("open" | "close",
    record)`` as the recorder makes them."""
    events = []
    opened, closed = profile._open, profile._close

    def _open(name, root, counts, t0):
        rec = opened(name, root, counts, t0)
        events.append(("open", rec))
        return rec

    def _close(rec, t1):
        closed(rec, t1)
        events.append(("close", rec))

    monkeypatch.setattr(profile, "_open", _open)
    monkeypatch.setattr(profile, "_close", _close)
    return events


def _parent(rec):
    return rec.parent.name if rec.parent is not None else None


def _patch_state(device="cpu", model_type="scratch", **cfg):
    torch.manual_seed(0)
    model = CRW(CRWConfig(model_type=model_type, temperature=0.05,
                          edgedrop_rate=0.1, **cfg))
    return create_train_state(model, make_optimizer(lr=3e-4), device=device)


def _superpixel_batch(gen):
    unit = torch.rand((2, 4, 64, 64, 3), generator=gen)
    return (unit - 0.5) / 0.25, slic_fused(unit, 9, 30.0)


def _steps(superpixel: bool, model_type: str = "scratch"):
    """A tiny CPU CRW state and a function that runs one train step of it
    on a fixed batch (patches, or whole frames with SLIC ids); ResNet-50
    on a smaller batch of patches."""
    gen = torch.Generator().manual_seed(1)
    if model_type == "scratch50":
        state = _patch_state(model_type=model_type)
        batch, kw = torch.randn((1, 3, 4, 32, 32, 3), generator=gen), {}
    elif superpixel:
        state = _patch_state(max_sp_num=12, dilate_superpixels=True,
                             dilation_kernel_size=7)
        frames, mask = _superpixel_batch(gen)
        batch, kw = frames, dict(sp_mask=mask)
    else:
        state = _patch_state()
        batch, kw = torch.randn((2, 4, 4, 32, 32, 3), generator=gen), {}
    step = make_train_step()

    def run():
        return step(state, batch, torch.Generator().manual_seed(0), **kw)
    return state, run


def _on_another_thread(spans, name):
    """A span opened and closed on a thread with no open span of its own
    (as autograd's backward thread)."""
    t = threading.Thread(target=lambda: spans.end(spans.begin(name)))
    t.start()
    t.join()


def test_nesting_parents_and_root_ids(spans):
    spans.enable()
    with spans.span("step", root=True, clips=4):
        with spans.span("trunk"):
            with spans.span("inner", rows=2) as s:
                s.add(rows=3)
            _on_another_thread(spans, "walk.backward")
    with spans.span("free"):
        _on_another_thread(spans, "loose")
    with spans.timed("video", root=True, frames=5) as v:
        v.add(targets=3)
    s = spans.summary()
    assert list(s) == ["inner", "walk.backward", "trunk", "step", "loose",
                       "free", "video"]
    # on its own thread a span nests in the open root, not in the other
    # thread's innermost span; with no root open it has no parent
    assert {name: x["parents"] for name, x in s.items()} == {
        "inner": ["trunk"], "walk.backward": ["step"], "trunk": ["step"],
        "step": [], "loose": [], "free": [], "video": []}
    assert v.seconds == pytest.approx(s["video"]["host_ms"] / 1e3,
                                      rel=1e-12)
    assert s["inner"]["counts"] == {"rows": 5}
    assert s["video"]["counts"] == {"frames": 5, "targets": 3}
    assert s["step"]["counts"] == {"clips": 4}
    children = s["trunk"]["host_ms"] + s["walk.backward"]["host_ms"]
    assert s["step"]["self_host_ms"] == pytest.approx(
        s["step"]["host_ms"] - children)
    assert s["trunk"]["self_host_ms"] == pytest.approx(
        s["trunk"]["host_ms"] - s["inner"]["host_ms"])
    assert all(x["device_ms"] is None for x in s.values())
    spans.reset()
    assert spans.summary() == {}


def test_folding_keeps_memory_bounded(spans, monkeypatch):
    monkeypatch.setattr(profile, "_FOLD_AT", 8)
    spans.enable()
    for _ in range(100):
        with spans.span("step", root=True):
            with spans.span("trunk"):
                pass
        assert len(profile._closed) <= 9
    s = spans.summary()
    assert s["step"]["n"] == s["trunk"]["n"] == 100
    assert s["step"]["self_host_ms"] == pytest.approx(
        s["step"]["host_ms"] - s["trunk"]["host_ms"])


def test_off_path_makes_no_call(spans, monkeypatch):
    calls = []

    def counting(name):
        def stub(*a, **kw):
            calls.append(name)
            raise AssertionError(f"{name} called while spans are off")
        return stub

    monkeypatch.setattr(profile, "record_function",
                        counting("record_function"))
    monkeypatch.setattr(torch.cuda, "Event", counting("Event"))
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        counting("register_hook"))
    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook",
                        counting("register_multi_grad_hook"))
    assert not profile.on()
    for superpixel, model_type in ((False, "scratch"), (True, "scratch"),
                                   (False, "scratch50")):
        _, run = _steps(superpixel, model_type)
        run()

    class NoGraph:
        @property
        def grad_fn(self):
            calls.append("grad_fn")

    profile.backward_span("walk.backward", NoGraph(), torch.zeros(1))
    assert profile.span("step", root=True) is profile.span("trunk")
    assert profile.begin("walk.backward") is None
    assert calls == [] and profile.summary() == {}


def test_on_under_a_profiler_session_and_off_after(spans):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profile.on()
        with spans.span("inside"):
            pass
    assert not profile.on()
    with spans.span("after"):
        pass
    assert list(spans.summary()) == ["inside"]


@pytest.mark.parametrize("superpixel", [False, True],
                         ids=["patch", "superpixel"])
def test_backward_spans_open_and_close_in_order(spans, log, superpixel):
    state, run = _steps(superpixel)
    run()                                  # warm: nothing recorded
    assert spans.summary() == {} and log == []
    spans.enable()
    run()
    spans.disable()
    s = spans.summary()
    assert s["step"]["n"] == 1 and s["step"]["counts"] == {"clips": 2}
    order = (["optimizer"] + list(LAYERS)
             + [f"{n}.backward" for n in reversed(LAYERS)] + ["optimizer"])
    # the step's children, each closed before the next opens
    top = [(kind, rec.name) for kind, rec in log if _parent(rec) == "step"]
    assert top == [(kind, name) for name in order
                   for kind in ("open", "close")]
    step = log[0][1]
    assert log[0] == ("open", step) and log[-1] == ("close", step)
    for _, rec in log[1:-1]:                 # every span inside the step
        while rec.parent is not None:
            rec = rec.parent
        assert rec is step
    if superpixel:
        assert s["sp_pool"]["parents"] == ["nodes"]
    for p in state.model.parameters():
        assert not p._backward_hooks         # the hooks removed themselves
    n = len(log)
    run()                                    # off again: nothing new
    assert len(log) == n and spans.summary() == s


def _user_annotations(path, names):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("name") in names), key=lambda e: e["ts"])


def test_spans_are_nested_user_annotations(spans, log, tmp_path):
    _, run = _steps(superpixel=True)
    run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    recs = [rec for kind, rec in log if kind == "open"]
    names = {r.name for r in recs}
    assert {"step", "sp_pool", "trunk.backward"} <= names
    notes = _user_annotations(path, names)
    assert [e["name"] for e in notes] == [r.name for r in recs]

    def innermost(e):
        outer = [o for o in notes if o is not e and o["ts"] <= e["ts"]
                 and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        return min(outer, key=lambda o: o["dur"])["name"] if outer else None

    assert [innermost(e) for e in notes] == [_parent(r) for r in recs]


def test_eval_seconds_are_the_spans(spans, log, tmp_path):
    from _synth import make_crw_checkpoint, make_davis_tree
    from videowalk_tpu_torch.cli import test as cli_test
    from videowalk_tpu_torch.eval.make_davis_vallist import make_list

    root = str(tmp_path / "DAVIS")
    make_davis_tree(root, hw=64, frames=6)
    lst = tmp_path / "davis_vallist.txt"
    lst.write_text("\n".join(make_list(root)) + "\n")
    args = types.SimpleNamespace(
        filelist=str(lst), save_path=str(tmp_path / "res"),
        resume=make_crw_checkpoint(str(tmp_path / "model.pth"), "scratch",
                                   seed=3),
        model_type="scratch", head_depth=-1, remove_layers=["layer4"],
        no_l2=False, topk=5, videoLen=3, radius=6.0, temperature=0.05,
        cropSize=-1, imgSize=-1, long_mem=[0], texture=False, round=False,
        norm_mask=False, workers=0, batchSize=1, manualSeed=777, finetune=0,
        pca_vis=False, visdom=False, device="cpu", profile_dir="")
    spans.enable()
    stats = cli_test.main(args)
    recs = [rec for kind, rec in log if kind == "close"]
    seconds = {}
    for r in recs:
        seconds.setdefault(r.name, []).append((r.t1 - r.t0) / 1e9)
    assert len(stats) == 2 and len(seconds["video"]) == 2
    for i, st in enumerate(stats):
        assert st["encode_s"] == pytest.approx(seconds["encode"][i],
                                               rel=1e-12)
        assert st["propagate_s"] == pytest.approx(
            seconds["labels"][i] + seconds["propagate"][i], rel=1e-12)
        assert st["total_s"] == pytest.approx(seconds["video"][i], rel=1e-12)
    videos = [r for r in recs if r.name == "video"]
    assert [v.counts for v in videos] == [
        dict(frames=st["frames"], targets=st["targets"]) for st in stats]
    phases = [r for r in recs if _parent(r) == "video"]
    assert [r.name for r in phases] == 2 * [
        "encode", "labels", "propagate", "dump"]
    assert [r.parent for r in phases] == 4 * videos[:1] + 4 * videos[1:]


def test_data_time_is_the_data_wait_span(spans, log, capsys):
    def slow(n):
        for i in range(n):
            time.sleep(0.02)
            yield i

    spans.enable()
    logger = MetricLogger()
    assert list(logger.log_every(slow(3), 1, total=3)) == [0, 1, 2]
    waits = [(r.t1 - r.t0) / 1e9 for kind, r in log
             if kind == "close" and r.name == "data_wait"]
    assert len(waits) == 4                  # the last wait meets the end
    lines = [x for x in capsys.readouterr().out.splitlines()
             if "data: " in x]
    data = [float(x.split("data: ")[1].split()[0]) for x in lines]
    assert data == [round(sum(waits[:i + 1]) / (i + 1), 4)
                    for i in range(3)]


def test_trace_stop_prints_the_table(spans, tmp_path, capsys):
    spans.enable()
    with spans.span("before"):
        pass
    trace = profile.Trace(str(tmp_path), "t", torch.device("cpu"))
    trace.start()
    with spans.span("step", root=True, clips=2):
        with spans.span("trunk"):
            time.sleep(0.01)
    trace.stop()
    out = capsys.readouterr().out.splitlines()
    table = [x for x in out if x.startswith("span ")]
    assert [x.split()[1] for x in table] == ["trunk", "step"]
    assert all(" n      1 " in x and "device ms -" in x for x in table)
    assert table[0].endswith("  in step")
    assert table[1].endswith("  in - clips 2")
    assert os.listdir(tmp_path) == ["t.pt.trace.json"]


@pytest.mark.parametrize("model_type,n", [("scratch", 0), ("scratch50", 36)])
def test_pointwise_spans_of_the_bottleneck_convs(spans, log, model_type, n):
    """ResNet-50's 36 1x1 convs (16 Bottlenecks' conv1 and conv3, four
    projections) each run in a ``pointwise`` span inside ``trunk`` and
    their backward in a ``pointwise.backward`` span inside
    ``trunk.backward``, one at a time: a span closes on its weight's
    gradient, before the next conv's backward opens. ResNet-18's blocks
    open none."""
    _, run = _steps(False, model_type)
    run()
    spans.enable()
    run()
    spans.disable()
    s = spans.summary()
    for name, parent in (("pointwise", "trunk"),
                         ("pointwise.backward", "trunk.backward")):
        if not n:
            assert name not in s
            continue
        assert s[name]["n"] == n and s[name]["parents"] == [parent]
        seen = [kind for kind, rec in log if rec.name == name]
        assert seen == n * ["open", "close"]


@pytest.mark.parametrize("model_type", ["scratch", "scratch50"])
def test_spans_leave_the_trunk_bitwise(spans, model_type):
    """A train-mode trunk forward and its input gradient with spans on are
    bitwise those with spans off."""
    torch.manual_seed(0)
    model = CRW(CRWConfig(model_type=model_type)).encoder.model
    x = torch.randn((2, 3, 32, 32), generator=torch.Generator().manual_seed(2))
    outs = []
    for on in (False, True):
        m = copy.deepcopy(model)
        xi = x.clone().requires_grad_(True)
        if on:
            spans.enable()
        y = m(xi, True)
        y.square().sum().backward()
        spans.disable()
        outs.append((y.detach(), xi.grad, m.conv1.weight.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert ("pointwise" in spans.summary()) == (model_type == "scratch50")


@pytest.mark.cuda
def test_card_layer_spans_cover_the_step(spans):
    """On the card, the layer spans of a patch step (trunk, nodes and walk
    forward and backward, the optimizer) sum within 3% of the step's
    device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from videowalk_tpu_torch.ops import _build

    _build.build_all()
    state = _patch_state(device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator("cuda").manual_seed(1)
    batch = torch.randn((16, 4, 49, 64, 64, 3), generator=gen,
                        device="cuda")
    step = make_train_step()
    for _ in range(3):
        step(state, batch, gen)
    torch.cuda.synchronize()
    spans.enable()
    for _ in range(5):
        step(state, batch, gen)
    torch.cuda.synchronize()
    spans.disable()
    s = spans.summary()
    parts = [n for n in s if s.get(n) and n in
             (*LAYERS, *(f"{x}.backward" for x in LAYERS), "optimizer")]
    assert len(parts) == 7
    covered = sum(s[n]["device_ms"] for n in parts)
    total = s["step"]["device_ms"]
    assert s["step"]["n"] == 5
    assert abs(covered - total) <= 0.03 * total, (covered, total, s)
