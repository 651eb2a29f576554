"""The eval flags this port now takes, against the JAX package: ``--texture``
and the LAB branch of ``VOSDataset`` (items equal), and ``--encode-dtype
bfloat16`` (a bf16 trunk with f32 features). bf16 features must keep a
per-frame cosine above 0.99 to the JAX package's bf16 features and to the
port's own f32 features, the bound the JAX package holds its bf16 eval to
(``tests/test_eval_pipeline.py``)."""

import types

import numpy as np
import pytest
import torch

from videowalk_tpu.data.vos import VOSDataset as JaxVOS

from videowalk_tpu_torch.data.vos import VOSDataset

from _synth import make_crw_checkpoint, make_davis_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from videowalk_tpu_torch.eval.make_davis_vallist import make_list

    root = tmp_path_factory.mktemp("flags")
    davis = make_davis_tree(str(root / "DAVIS"), hw=64, frames=6)
    fl = root / "davis_vallist.txt"
    fl.write_text("\n".join(make_list(davis)) + "\n")
    ckpt = make_crw_checkpoint(str(root / "model.pth"), "scratch", seed=8)
    return str(fl), ckpt, root


def _args(filelist, **over):
    a = types.SimpleNamespace(
        filelist=filelist, save_path="", resume="", model_type="scratch",
        head_depth=-1, remove_layers=["layer4"], no_l2=False, topk=5,
        videoLen=3, radius=6.0, temperature=0.05, cropSize=-1, imgSize=-1,
        long_mem=[0], texture=False, round=False, norm_mask=False, workers=0,
        batchSize=1, manualSeed=777, finetune=0, pca_vis=False, visdom=False,
        mapScale=np.array([8, 8]))
    for k, v in over.items():
        setattr(a, k, v)
    return a


@pytest.mark.parametrize("over", [
    dict(texture=True), dict(texture=True, imgSize=32),
    dict(use_lab=True), dict(use_lab=True, imgSize=32)],
    ids=["texture", "texture_resized", "lab", "lab_resized"])
def test_vos_texture_and_lab_equal_jax(tree, over):
    fl = tree[0]
    for i in range(2):
        got = VOSDataset(_args(fl, **over))[i]
        want = JaxVOS(_args(fl, **over))[i]
        for a, b in zip(got[:5], want[:5]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[5] == want[5]
    if over.get("use_lab"):
        assert np.array_equal(got[0][..., 0], got[0][..., 2])
    elif "imgSize" not in over:         # stripes at 8x8 maps, zeros after
        assert np.any(got[2][0][..., 1:]) and not np.any(got[2][3:])


def _features(tree, dtype):
    """Both packages' encoders in ``dtype`` from the same ``.pth``, on four
    frames of the tree: (port, JAX) features ``(4, C, h, w)``."""
    import jax
    import jax.numpy as jnp

    from videowalk_tpu.cli.test import build_model as jax_build
    from videowalk_tpu.cli.test import encode_video as jax_encode
    from videowalk_tpu.utils import load_checkpoint as jax_load
    from videowalk_tpu.utils import partial_load as jax_partial

    from videowalk_tpu_torch.cli.test import build_model, encode_video
    from videowalk_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      partial_load)

    fl, ckpt, _ = tree
    imgs = VOSDataset(_args(fl))[0][0][3:7]          # raw uint8 frames
    args = _args(fl, encode_dtype=dtype)
    model = build_model(args, torch.device("cpu"))
    partial_load(load_checkpoint(ckpt)["model"], model, skip_keys=["head"])
    port = encode_video(model, imgs).numpy()

    jm, _ = jax_build(args)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 64, 64, 3)),
                just_feats=True, train=False)
    v = jax_partial(jax_load(ckpt)["model"], v, skip_keys=["head"])
    return port, np.asarray(jax_encode(jm, v, imgs))


def _cos(a, b):
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1) + 1e-12)


def test_bf16_encode_keeps_cosine_to_jax_and_to_f32(tree):
    port16, jax16 = _features(tree, "bfloat16")
    port32, jax32 = _features(tree, "float32")
    assert port16.dtype == np.float32 and port16.shape == (4, 256, 8, 8)
    np.testing.assert_allclose(port32, jax32, atol=1e-4)
    assert _cos(port16, jax16).min() > 0.99
    assert _cos(port16, port32).min() > 0.99
    assert not np.array_equal(port16, port32)       # the trunk ran in bf16


def test_bf16_eval_cli_runs_end_to_end(tree, tmp_path):
    import os

    from videowalk_tpu_torch.cli.test import main
    from videowalk_tpu_torch.utils.arguments import test_args

    fl, ckpt, _ = tree
    stats = main(test_args([
        "--device", "cpu", "--filelist", fl, "--resume", ckpt,
        "--encode-dtype", "bfloat16", "--cropSize", "-1", "--videoLen", "3",
        "--topk", "5", "--radius", "6", "--save-path", str(tmp_path)]))
    assert [s["targets"] for s in stats] == [6, 6]
    assert os.path.exists(tmp_path / "1_5_mask.png")
