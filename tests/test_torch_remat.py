"""Rematerialization of the port's trunk (``CRWConfig.remat`` /
``remat_stages``, ``torch.utils.checkpoint`` per block) and the train
CLI's ``--remat`` / ``--remat-stages`` resolution, held to what
``tests/test_models_extra.py`` and ``tests/test_edge_paths.py`` hold the
JAX package to. The port takes the stage set as an argument: the JAX
package's ``VIDEOWALK_REMAT_STAGES`` environment knob has no counterpart
(as ``VIDEOWALK_RCONV`` has none, ``ops/reflect_conv.py``)."""

import argparse

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.cli.train import resolve_remat_args
from videowalk_tpu_torch.models import CRW, CRWConfig, CRWTeacherStudent
from videowalk_tpu_torch.models.resnet import ALL_STAGES, remat_stage_set
from videowalk_tpu_torch.parallel import (create_train_state, make_optimizer,
                                          make_train_step)

torch.set_num_threads(1)

ARMS = (("none", dict(remat=False)),
        ("all", dict(remat=True)),
        ("sel", dict(remat=True, remat_stages="layer1,layer2,layer3")),
        ("layer1", dict(remat=True, remat_stages="layer1")))


def _step(model_type, kw, batch):
    """One seeded train step; returns the loss, the flat updated
    parameters, the buffers and each stage's block forward calls."""
    torch.manual_seed(0)
    model = CRW(CRWConfig(model_type=model_type, temperature=0.05, **kw))
    calls = dict.fromkeys(model.encoder.model.stages, 0)

    def counted(forward, name):
        def run(*args, **kwargs):
            calls[name] += 1
            return forward(*args, **kwargs)
        return run

    for name in calls:          # forward hooks do not fire on a recompute
        for blk in getattr(model.encoder.model, name):
            blk.forward = counted(blk.forward, name)
    state = create_train_state(model, make_optimizer(lr=1e-3), device="cpu")
    metrics = make_train_step()(state, batch, torch.Generator().manual_seed(7))
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return float(metrics["loss"]), flat.numpy(), {
        k: v.clone() for k, v in model.named_buffers()}, calls


@pytest.mark.parametrize("model_type", ["scratch", "scratch50"])
def test_remat_matches_no_remat(model_type):
    """Remat is graph surgery: the loss (rtol 1e-6) and the updated
    parameters (rtol 1e-4, atol 1e-7) of one Adam step equal the no-remat
    step's, as in the JAX package's test; the BN running statistics equal
    and ``num_batches_tracked`` is 1 (the recompute does not update them
    again); each rematerialized stage's blocks run their forward twice, the
    others once. ``scratch`` routes its 8x8 3x3s (the plain versions of
    the reflect-conv kernels with the BN-input chain); ``scratch50`` (layer3
    and layer4 removed) its Bottlenecks' 3x3s with bn2's moments."""
    rng = np.random.RandomState(1)
    batch = torch.from_numpy(rng.randn(1, 3, 4, 32, 32, 3).astype(np.float32))
    kw = ({} if model_type == "scratch"
          else dict(remove_layers=("layer3", "layer4")))
    got = {name: _step(model_type, dict(kw, **arm), batch)
           for name, arm in ARMS}
    loss0, flat0, bufs0, calls0 = got["none"]
    n_blocks = {name: calls0[name] for name in calls0}
    for name, arm in ARMS[1:]:
        loss, flat, bufs, calls = got[name]
        np.testing.assert_allclose(loss, loss0, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(flat, flat0, rtol=1e-4, atol=1e-7,
                                   err_msg=name)
        for k, v in bufs0.items():
            if k.endswith("num_batches_tracked"):
                assert int(bufs[k]) == int(v) == 1, (name, k)
            else:
                np.testing.assert_allclose(bufs[k].numpy(), v.numpy(),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{name} {k}")
        stages = remat_stage_set(arm.get("remat_stages"))
        assert calls == {s: n_blocks[s] * (2 if s in stages else 1)
                         for s in calls}, name


def test_teacher_student_remat_matches_no_remat():
    """The teacher-student step under full remat: the student's loss and
    updated parameters equal the no-remat step's (tolerances as above);
    the frozen teacher runs under ``no_grad`` and is not rematerialized."""
    rng = np.random.RandomState(2)
    batch = torch.from_numpy(rng.randn(1, 3, 4, 32, 32, 3).astype(np.float32))
    out = []
    for kw in (dict(remat=False), dict(remat=True)):
        torch.manual_seed(0)
        model = CRWTeacherStudent(CRWConfig(
            model_type="scratch", temperature=0.05,
            remove_layers=("layer4",), **kw), alpha=0.5)
        state = create_train_state(model, make_optimizer(lr=1e-3),
                                   device="cpu", frozen_prefixes=("teacher.",))
        metrics = make_train_step()(state, batch,
                                    torch.Generator().manual_seed(7))
        out.append((float(metrics["loss"]), torch.cat(
            [p.detach().reshape(-1) for p in model.parameters()]).numpy()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-4, atol=1e-7)


def test_remat_stage_set():
    """``None``, ``""`` and ``"all"`` are every stage; a comma list its
    stages; a typo raises (it would buy no memory and cost the
    recompute), as the JAX ``_remat_stage_set``."""
    for every in (None, "", "all"):
        assert remat_stage_set(every) == ALL_STAGES
    assert remat_stage_set(" layer1, layer3 ,") == {"layer1", "layer3"}
    with pytest.raises(ValueError, match="unknown stage"):
        remat_stage_set("layer1,layr2")
    with pytest.raises(ValueError, match="unknown stage"):
        CRW(CRWConfig(remat=True, remat_stages="layer5"))
    CRW(CRWConfig(remat=False, remat_stages="layer5"))   # inert, as in JAX


def test_resolve_remat_args(capsys):
    """Bare ``--remat`` resolves to ``layer1`` with a note; explicit
    stages survive; ``--remat-stages`` without ``--remat`` warns that it is
    inert; a typo fails at startup (``tests/test_edge_paths.py``'s cases
    but the environment knob)."""
    a = argparse.Namespace(remat=True, remat_stages=None)
    resolve_remat_args(a)
    assert a.remat_stages == "layer1"
    assert "layer1" in capsys.readouterr().out

    a = argparse.Namespace(remat=True, remat_stages="all")
    resolve_remat_args(a)
    assert a.remat_stages == "all"
    assert capsys.readouterr().out == ""

    a = argparse.Namespace(remat=False, remat_stages="layer1")
    resolve_remat_args(a)
    assert a.remat_stages == "layer1"
    assert "inert" in capsys.readouterr().out

    a = argparse.Namespace(remat=False, remat_stages=None)
    resolve_remat_args(a)
    assert a.remat_stages is None and capsys.readouterr().out == ""

    with pytest.raises(ValueError, match="unknown stage"):
        resolve_remat_args(argparse.Namespace(remat=True,
                                              remat_stages="layer9"))
