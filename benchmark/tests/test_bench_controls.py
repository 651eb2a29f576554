"""The check's control and planted faults, through the harness at a size a
test run holds: each must make ``correct`` come out false under the
cells' own limits, where the unbroken run comes out true.

The runs skip the harness's look for a card and take the CPU, where the
program takes its kernels' plain versions; the training runs there in
f32 (``--dtype float32``), as PyTorch's CPU bf16 convolutions at this size
read several times the card's bf16 gaps. Faults, each planted in the
program's timed path:

- training: a step that returns its state unchanged (the forward alone:
  no backward, no update); half of the batch left out, the mean taken
  over the rest;
- eval: an answer altered where it is produced (each target's predicted
  labels rolled by one label, in ``prop_sparse``'s output).

The control (the reference one precision below the configuration's, in
the program's place): fp8 convolutions for training, on the CPU; TF32 for
eval, which exists only on the card."""

import copy
import time

import pytest
import torch

import run
from harness import common

SEED = 2 ** 33 + 101


def tiny(name: str) -> dict:
    cell = copy.deepcopy(common.load_cell(name))
    if cell["traffic"]["loop"] == "train":
        if cell["traffic"]["nodes"] == "superpixel":
            flags = ["--batch-size", "2", "--img-size", "64", "--num-sp",
                     "9", "--compactness", "30",
                     "--dilation-kernel-size", "9"]
        else:
            flags = ["--batch-size", "2", "--clip-len", "4", "--img-size",
                     "64", "--patch-size", "32", "32", "3"]
        cell["config"]["train_flags"] = (cell["config"]["train_flags"]
                                         + flags + ["--dtype", "float32"])
        cell["traffic"].update(pool=3, texture_cell=8)
    else:
        cell["config"]["eval_flags"] = (cell["config"]["eval_flags"]
                                        + ["--videoLen", "3"])
        cell["traffic"].update(height=64, width=96, lengths=[3, 4],
                               objects=[1, 2], texture_cell=8)
    return cell


def run_tiny(name: str) -> dict:
    torch.manual_seed(0)
    return run.run_cell(tiny(name), SEED, 0.5, False, "cpu",
                        time.perf_counter())


TRAIN = ["train-patch-b32", "train-sp-b160"]


@pytest.mark.parametrize("name", TRAIN + ["eval-davis-480p"])
def test_unbroken_run_is_correct(name):
    assert run_tiny(name)["correct"]


def forward_only_step(original):
    def make():
        def step(state, batch, generator=None, sp_mask=None):
            kwargs = {} if sp_mask is None else {"sp_mask": sp_mask}
            with torch.no_grad():
                _, loss, _ = state.model(batch, train=True,
                                         generator=generator, **kwargs)
            state.step += 1
            return {"loss": loss}
        return step
    return make


def half_batch_step(original):
    def make():
        step = original()

        def half(state, batch, generator=None, sp_mask=None):
            b = batch.shape[0] // 2
            return step(state, batch[:b], generator,
                        None if sp_mask is None else sp_mask[:b])
        return half
    return make


@pytest.mark.parametrize("fault", [forward_only_step, half_batch_step])
@pytest.mark.parametrize("name", TRAIN)
def test_training_faults_fail(monkeypatch, name, fault):
    import videowalk_tpu_torch.parallel as parallel

    monkeypatch.setattr(parallel, "make_train_step",
                        fault(parallel.make_train_step))
    result = run_tiny(name)
    assert not result["correct"], result["checks"]


def test_eval_altered_answer_fails(monkeypatch):
    from videowalk_tpu_torch.eval import propagation

    original = propagation.prop_sparse

    def altered(*a, **kw):
        return original(*a, **kw).roll(1, dims=-1)

    monkeypatch.setattr(propagation, "prop_sparse", altered)
    result = run_tiny("eval-davis-480p")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_training_control_fails(name):
    cell = tiny(name)
    runner = run.make_runner(cell, SEED, "cpu")
    runner.setup()
    runner.free()
    reference = runner.reference_records()
    control = runner.reference_records("fp8")
    ok, checks = run.judge(runner.compare(control, reference),
                           cell["checks"]["limits"])
    assert not ok, checks


@pytest.mark.cuda
def test_eval_control_fails(card):
    cell = tiny("eval-davis-480p")
    runner = run.make_runner(cell, SEED, card)
    runner.setup()
    runner.window(0.5, False)
    runner.free()
    reference = runner.reference_records()
    control = runner.reference_records("tf32")
    ok, checks = run.judge(runner.compare(control, reference),
                           cell["checks"]["limits"])
    assert not ok, checks


def tiny_resnet50() -> dict:
    """The patch cell with ``scratch50``'s ResNet-50 trunk, by its flags
    alone: the harness takes the trunk from the configuration."""
    cell = tiny("train-patch-b32")
    cell["config"]["train_flags"] += ["--model-type", "scratch50"]
    return cell


def test_resnet50_cell_is_correct():
    torch.manual_seed(0)
    result = run.run_cell(tiny_resnet50(), SEED, 0.5, False, "cpu",
                          time.perf_counter())
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [forward_only_step, half_batch_step])
def test_resnet50_cell_faults_fail(monkeypatch, fault):
    import videowalk_tpu_torch.parallel as parallel

    monkeypatch.setattr(parallel, "make_train_step",
                        fault(parallel.make_train_step))
    torch.manual_seed(0)
    result = run.run_cell(tiny_resnet50(), SEED, 0.5, False, "cpu",
                          time.perf_counter())
    assert not result["correct"], result["checks"]
