"""The port's host-to-device prefetcher (``data/prefetch.py``) and train
meters (``utils/meters.py``): order, the consumed views only, exceptions in
the loader's order; on the card (``-m cuda``) the side-stream copies land
before the consumer reads them and are not overwritten while a slow step
still reads them."""

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.data.prefetch import DevicePrefetcher
from videowalk_tpu_torch.utils.meters import MetricLogger, SmoothedValue

torch.set_num_threads(1)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _batches(n, shape=(2, 3), fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise OSError(f"decode failed at batch {i}")
        views = {"grid": np.full(shape, i, np.float32),
                 "whole": np.full(shape, -i, np.float32)}
        yield views, np.zeros((2, 0), np.int32), np.array([i, i])


class _Loader:
    def __init__(self, n, **kw):
        self.n, self.kw = n, kw

    def __len__(self):
        return self.n

    def __iter__(self):
        return _batches(self.n, **self.kw)


def test_cpu_passes_the_consumed_views_through_in_order():
    pf = DevicePrefetcher(_Loader(5), size=2, keys={"grid"}, device="cpu")
    assert len(pf) == 5
    got = list(pf)
    assert [int(v["grid"][0, 0]) for v, _, _ in got] == list(range(5))
    for i, (views, mask, label) in enumerate(got):
        assert torch.is_tensor(views["grid"])
        assert isinstance(views["whole"], np.ndarray)   # not consumed
        assert torch.is_tensor(mask) and tuple(mask.shape) == (2, 0)
        assert isinstance(label, np.ndarray) and label[0] == i


def test_a_loader_exception_comes_at_its_place():
    seen = []
    with pytest.raises(OSError, match="batch 3"):
        for views, _, _ in DevicePrefetcher(_Loader(6, fail_at=3), size=2,
                                            device="cpu"):
            seen.append(int(views["grid"][0, 0]))
    assert seen == [0, 1, 2]
    with pytest.raises(ValueError):
        DevicePrefetcher(_Loader(1), size=0, device="cpu")


def test_meters_smooth_and_log(capsys):
    v = SmoothedValue(window_size=3)
    for x in (4, 1, 3, 2):
        v.update(x)
    assert (v.median, v.avg, v.global_avg, v.max, v.value) == (2, 2, 2.5, 3, 2)
    log = MetricLogger(delimiter="  ")
    log.add_meter("lr", SmoothedValue(window_size=1, fmt="{value}"))
    for i in log.log_every(range(3), 2, "Epoch: [0]"):
        log.update(loss=float(i), lr=0.1)
    out = capsys.readouterr().out
    assert "[0/3]" in out and "[2/3]" in out and "[1/3]" not in out
    assert "lr: 0.1" in out and "Total time" in out
    assert log.loss.global_avg == 1.0


@pytest.mark.cuda
def test_card_copies_land_before_the_consumer_reads_them():
    """Batches of 16 MiB copied on the side stream while the consumer's
    stream is held back by a long kernel before each read: every batch
    reads its own values (the consumer waited on the copy), and a batch
    read after later copies were issued still holds its own (its memory was
    not handed to them)."""
    _need_card()
    n, shape = 8, (1024, 4096)
    pf = DevicePrefetcher(_Loader(n, shape=shape), size=3, keys={"grid"},
                          device="cuda")
    sums, held = [], []
    for views, _, _ in pf:
        torch.cuda._sleep(20_000_000)         # ~10 ms on the consumer stream
        g = views["grid"]
        assert g.is_cuda
        sums.append(g.sum())
        held.append(g)
        if len(held) > 2:
            held.pop(0)
    torch.cuda.synchronize()
    want = [float(i * shape[0] * shape[1]) for i in range(n)]
    assert [float(s) for s in sums] == want
    for g, i in zip(held, (n - 2, n - 1)):
        assert float(g.min()) == float(g.max()) == i
