"""A cell on one process a card, at a size a test run holds: two ranks over
gloo on the CPU (``harness/ranks.py``), each stepping its row block of the
global batch, the reference over the ranks' row blocks. The unbroken run
reads ``correct``; the exchange left out (each rank stepping its rows with
no group, ``calibrate.exchange_left_out``) does not, nor does half of each
rank's rows left out; a rank that loads a forbidden module fails the run,
and no result is printed."""

import contextlib
import functools
import sys
import time

import pytest
import torch

import calibrate
import run
from harness import common
from test_bench_controls import SEED, half_batch_step, tiny

CELL = "train-patch-b32-dp4"


def two_ranks() -> dict:
    cell = tiny(CELL)
    cell["chips"] = 2
    cell["config"]["train_flags"] += ["--print-freq", "2"]
    return cell


def planted(rank, device, group, *args, plant=None):
    """``run.run_rank`` with ``plant`` in this rank: ``exchange`` leaves
    the program's exchange out; ``half_batch`` steps the first half of the
    rank's rows; ``jax`` puts a module named ``jaxlib`` into rank 1's
    ``sys.modules``."""
    import videowalk_tpu_torch.parallel as parallel

    torch.set_num_threads(2)
    if plant == "jax" and rank == 1:
        sys.modules["jaxlib"] = sys
    if plant == "half_batch":
        parallel.make_train_step = half_batch_step(parallel.make_train_step)
    with (calibrate.exchange_left_out() if plant == "exchange"
          else contextlib.nullcontext()):
        return run.run_rank(rank, device, group, *args)


def run_two(plant=None) -> tuple[dict, list]:
    return run.run_ranks(two_ranks(), SEED, 0.5, False, time.perf_counter(),
                         device_type="cpu",
                         target=functools.partial(planted, plant=plant))


def test_two_ranks_are_correct():
    result, found = run_two()
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 2 and result["attempted"] > 0
    assert found == [[], []]


def test_the_exchange_left_out_fails():
    result, _ = run_two("exchange")
    assert not result["correct"], result["checks"]


def test_half_of_each_ranks_rows_fails():
    result, _ = run_two("half_batch")
    assert not result["correct"], result["checks"]


def test_a_rank_with_jax_loaded_fails_the_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cell = two_ranks()
    monkeypatch.setattr(common, "load_cell", lambda name: cell)
    monkeypatch.setattr(run, "run_ranks", functools.partial(
        run.run_ranks, device_type="cpu",
        target=functools.partial(planted, plant="jax")))
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                  "0.5"])
    out = capsys.readouterr()
    assert exc.value.code != 0 and out.out == ""
    assert "rank 1" in out.err and "jaxlib" in out.err


def test_an_eval_cell_runs_on_one_card():
    cell = tiny("eval-davis-480p")
    cell["chips"] = 2
    with pytest.raises(ValueError):
        run.make_runner(cell, SEED, "cpu")
