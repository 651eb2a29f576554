"""The encoder variants through the port's trainer: ``python -m
videowalk_tpu_torch.cli.train --model-type scratch50 --remat`` on the
synthetic Kinetics tree (``tests/_synth.py``), its ``.pth`` read by the JAX
package, and a ``.pth`` the JAX package writes for ``scratch50`` read by
the port; then a pretrained type's encoder loaded by the trainer before its
steps.

Tolerance: features atol 1e-5 (one f32 evaluation by each package at the
same weights; unit vectors); weights exact."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig
from videowalk_tpu.utils.checkpoint import (load_checkpoint as jax_load,
                                            save_checkpoint as jax_save,
                                            torch_to_flax_state)

from videowalk_tpu_torch.cli import train as cli
from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.utils.arguments import train_args
from videowalk_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  state_from_flax)

from _synth import make_kinetics_tree
from test_torch_resnet50 import seeded_variables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def kinetics(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kinetics"))
    make_kinetics_tree(root)
    return os.path.join(root, "val_256")


def _argv(data, out, model_type, *extra):
    """Two patch steps of 16 px patches of 64 px frames, 4-frame clips,
    batch 2, on the CPU."""
    return ["--device", "cpu", "--data-path", data, "--frame-aug", "grid",
            "--clip-len", "4", "--temp", "0.05", "--dropout", "0.1",
            "--model-type", model_type, "--img-size", "64",
            "--patch-size", "16", "16", "3", "--lr", "0.0003", "--prob", "1.0",
            "--epochs", "1", "--steps-per-epoch", "2", "--batch-size", "2",
            "--workers", "2", "--print-freq", "1",
            "--cache-path", os.path.join(out, "cache.pt"),
            "--output-dir", os.path.join(out, "ck"),
            "--logs-dir", os.path.join(out, "logs"), *extra]


def test_scratch50_pth_crosses_both_ways(kinetics, tmp_path, capsys):
    """Two ``scratch50`` steps (layer4 removed: 1024-d features) under bare
    ``--remat`` (``layer1``) finish (a non-finite loss aborts at each
    fetch); the JAX package's ``load_checkpoint`` +
    ``torch_to_flax_state`` fill every leaf of its ``scratch50`` CRW from
    the written ``checkpoint.pth`` and give the port's features; a ``.pth``
    the JAX package writes from seeded ``scratch50`` variables loads into
    the port with ``strict=True``, weight for weight, and gives the JAX
    features."""
    state = cli.main(train_args(_argv(kinetics, str(tmp_path), "scratch50",
                                      "--remove-layers", "layer4",
                                      "--remat")))
    out = capsys.readouterr().out
    assert "uses 'layer1'" in out and "Epoch: [0]  [1/2]" in out
    assert state.step == 2
    assert state.model.encoder.model.remat_stages == {"layer1"}
    path = os.path.join(tmp_path, "ck", "checkpoint.pth")

    x = np.random.RandomState(0).randn(1, 3, 2, 16, 16, 3).astype(np.float32)
    cfg = dict(model_type="scratch50", temperature=0.05,
               remove_layers=("layer4",))
    jm = JaxCRW(JaxConfig(**cfg))
    template = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    feats = jax.jit(lambda v, a: jm.apply(v, a, just_feats=True,
                                          train=False)[0])

    def port_feats(state_dict):
        model = CRW(CRWConfig(**cfg))
        model.load_state_dict(state_dict, strict=True)
        with torch.no_grad():
            return model(torch.from_numpy(x), just_feats=True,
                         train=False)[0].numpy()

    loaded = torch_to_flax_state(jax_load(path)["model"], template,
                                 verbose=False)
    assert all(isinstance(leaf, jax.Array)
               for leaf in jax.tree_util.tree_leaves(loaded))
    np.testing.assert_allclose(port_feats(load_checkpoint(path)["model"]),
                               np.asarray(feats(loaded, jnp.asarray(x))),
                               atol=1e-5)

    variables = seeded_variables(template, np.random.RandomState(5))
    jax_path = str(tmp_path / "jax_scratch50.pth")
    jax_save(jax_path, variables, lr_scheduler_state={"step": 0})
    state_dict = load_checkpoint(jax_path)["model"]
    for k, v in state_from_flax(variables).items():
        assert torch.equal(state_dict[k], v), k
    np.testing.assert_allclose(port_feats(state_dict),
                               np.asarray(feats(variables, jnp.asarray(x))),
                               atol=1e-5)


def test_trainer_loads_a_pretrained_encoder_before_training(
        kinetics, tmp_path, capsys):
    """``--model-type uvc --pretrained-path``: the trainer loads the file's
    encoder before its first step (and says so); ``imagenet18`` without a
    path stops before any step, naming the flag."""
    from test_torch_pretrained import torchvision_state

    r18 = torchvision_state(18, 7)
    path = str(tmp_path / "uvc.pth.tar")
    torch.save({"state_dict": {f"module.gray_encoder.{k}": v
                               for k, v in r18.items()}}, path)
    args = train_args(_argv(kinetics, str(tmp_path), "uvc",
                            "--remove-layers", "layer4",
                            "--pretrained-path", path, "--lr", "0"))
    state = cli.main(args)
    assert "Loaded pretrained uvc encoder weights from" in capsys.readouterr(
    ).out
    got = state.model.state_dict()
    for k in ("conv1.weight", "layer3.1.conv2.weight", "layer1.0.bn1.bias"):
        assert torch.equal(got["encoder.model." + k], r18[k]), k
    with pytest.raises(ValueError, match="--pretrained-path"):
        cli.main(train_args(_argv(kinetics, str(tmp_path / "b"),
                                  "imagenet18")))
