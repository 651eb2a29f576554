"""The port's pretrained-encoder import (``utils/pretrained.py``) against the
JAX package's: the key-schema normalizers on seeded dicts in each schema,
``apply_pretrained_encoder`` on a CRW and on a teacher-student, its errors,
and the eval CLI with a pretrained model type against the JAX eval CLI.

Every checkpoint is built here from seeded arrays under torchvision's key
names (the port's own ``resnet18`` / ``resnet50`` ``state_dict`` names,
plus the ``fc`` head the trunk drops): no published weights exist in this
repository."""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig
from videowalk_tpu.models.teacher_student import CRWTeacherStudent as JaxTS
from videowalk_tpu.utils import pretrained as jax_pretrained

from videowalk_tpu_torch.models import CRW, CRWConfig, CRWTeacherStudent
from videowalk_tpu_torch.models.resnet import resnet18, resnet50
from videowalk_tpu_torch.utils import pretrained
from videowalk_tpu_torch.utils.checkpoint import state_from_flax

from _synth import make_davis_tree
from test_torch_resnet50 import seeded_variables

torch.set_num_threads(1)


def torchvision_state(depth: int, seed: int) -> dict:
    """A torchvision ResNet-``depth`` ``state_dict`` of seeded values (the
    ``fc`` head included, which the trunk drops): He-scaled kernels, BN
    weights near 1, small biases and running means, running variances in
    [0.5, 1.5], counters 0-d int64. (Kernels of scale 0.05 would make every
    eval feature of a ResNet-50 the same direction, and top-k ties.)"""
    rng = np.random.RandomState(seed)
    trunk = resnet18() if depth == 18 else resnet50()
    shapes = {k: tuple(v.shape) for k, v in trunk.state_dict().items()}
    shapes["fc.weight"] = (1000, trunk.hid_dim)
    shapes["fc.bias"] = (1000,)
    out = {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.tensor(0, dtype=torch.int64)
            continue
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) > 1:
            v = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("weight"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:                                 # bias, running_mean
            v = 0.1 * rng.randn(*shape)
        out[k] = torch.from_numpy(v.astype(np.float32))
    return out


def _schema_files(tmp_path):
    """One seeded file a model type, in its family's schema: the imagenet
    file under ``module.``, MoCo's with its MLP head and momentum-encoder
    keys, TimeCycle's with 5-D kernels (one with a real time axis), 0-d
    counters and a foreign key, UVC's and VINCE's beside foreign keys."""
    r18, r50 = torchvision_state(18, 1), torchvision_state(50, 2)
    moco = {f"module.encoder_q.{k}": v for k, v in r50.items()
            if not k.startswith("fc.")}
    moco["module.encoder_q.fc.0.weight"] = torch.zeros(2048, 2048)
    moco["module.encoder_q.fc.2.weight"] = torch.zeros(128, 2048)
    moco["module.encoder_k.conv1.weight"] = torch.ones(64, 3, 7, 7)
    tc = {f"module.encoderVideo.{k}": (v[:, :, None] if v.dim() == 4 else v)
          for k, v in r50.items() if not k.startswith("fc.")}
    tc["module.encoderVideo.extra3d.weight"] = torch.ones(4, 3, 2, 3, 3)
    tc["module.afterconv1.weight"] = torch.ones(8, 8)
    uvc = {f"module.gray_encoder.{k}": v for k, v in r18.items()
           if not k.startswith("fc.")}
    uvc["module.rgb_encoder.conv1.weight"] = torch.ones(64, 3, 7, 7)
    vince = {f"feature_extractor.module.model.{k}": v
             for k, v in r18.items()}
    vince["embedding.weight"] = torch.ones(4, 4)
    files = {
        "imagenet18": r18,
        "imagenet50": {f"module.{k}": v for k, v in r50.items()},
        "moco50": {"state_dict": moco},
        "timecycle": {"state_dict": tc},
        "uvc": {"state_dict": uvc},
        "vince": {"model": vince},
    }
    paths = {}
    for t, obj in files.items():
        paths[t] = str(tmp_path / f"{t}.pth")
        torch.save(obj, paths[t])
    return paths


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _schema_files(tmp_path_factory.mktemp("pretrained"))


@pytest.mark.parametrize("model_type", ["imagenet18", "imagenet50", "moco50",
                                        "timecycle", "uvc", "vince"])
def test_normalizers_match_jax(files, model_type):
    """Each schema's normalized state equals the JAX normalizer's: the same
    keys (MoCo's head kept for the partial load to skip, foreign keys
    dropped, prefixes stripped) and the same values (TimeCycle's singleton
    time axes squeezed, its real one kept, 0-d counters kept)."""
    got = pretrained.load_pretrained_state(model_type, files[model_type])
    want = jax_pretrained.load_pretrained_state(model_type,
                                                files[model_type])
    assert set(got) == set(want)
    for k, v in want.items():
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    if model_type == "timecycle":
        assert got["conv1.weight"].shape == (64, 3, 7, 7)
        assert got["extra3d.weight"].dim() == 5
        assert got["bn1.num_batches_tracked"].dim() == 0
    if model_type == "moco50":
        assert "fc.0.weight" in got and "conv1.weight" in got


def _jax_variables(model, x, seed):
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), x, train=False))
    return seeded_variables(shapes, np.random.RandomState(seed))


@pytest.mark.parametrize("model_type,teacher_student", [
    ("imagenet18", False), ("uvc", True), ("moco50", False),
    ("timecycle", True)])
def test_apply_pretrained_encoder_matches_jax(files, model_type,
                                              teacher_student):
    """The same seeded model in both packages, the same file: every weight
    after the import equals the JAX function's (the CRW's encoder, or both
    towers of the teacher-student), and the head is untouched. ResNet-50
    types keep layer1 alone, which the file's other stages do not fit."""
    r50 = model_type in ("moco50", "timecycle")
    cfg = dict(model_type=model_type, head_depth=0, remove_layers=(
        ("layer2", "layer3", "layer4") if r50 else ("layer4",)))
    x = jnp.zeros((1, 2, 2, 32, 32, 3))
    if teacher_student:
        jm = JaxTS(JaxConfig(**cfg), alpha=0.5)
        model = CRWTeacherStudent(CRWConfig(**cfg), alpha=0.5)
    else:
        jm = JaxCRW(JaxConfig(**cfg))
        model = CRW(CRWConfig(**cfg))
    variables = _jax_variables(jm, x, seed=4)
    model.load_state_dict(state_from_flax(variables), strict=True)
    want = state_from_flax(jax.tree_util.tree_map(
        np.asarray, jax_pretrained.apply_pretrained_encoder(
            variables, model_type, files[model_type], verbose=False)))
    head0 = {k: v.clone() for k, v in model.state_dict().items()
             if "selfsim_fc" in k}
    loaded = pretrained.apply_pretrained_encoder(
        model, model_type, files[model_type], verbose=False)
    assert "encoder.model.layer1.0.conv1.weight" in loaded
    assert ("teacher.encoder.model.conv1.weight" in loaded) == teacher_student
    got = model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=k)
    for k, v in head0.items():
        assert torch.equal(got[k], v), k


def test_import_errors(files, tmp_path):
    """No path, an unknown schema, a file in another schema and a file
    whose keys match no weight each raise, naming the fault."""
    model = CRW(CRWConfig(model_type="imagenet18", remove_layers=("layer4",)))
    with pytest.raises(ValueError, match="--pretrained-path"):
        pretrained.apply_pretrained_encoder(model, "imagenet18", "")
    with pytest.raises(ValueError, match="no pretrained schema"):
        pretrained.load_pretrained_state("scratch", files["imagenet18"])
    with pytest.raises(ValueError, match="no keys matching the 'uvc'"):
        pretrained.apply_pretrained_encoder(model, "uvc", files["moco50"])
    stray = str(tmp_path / "stray.pth")
    torch.save({"head.weight": torch.ones(3, 3),
                "layer9.0.conv1.weight": torch.ones(3, 3)}, stray)
    with pytest.raises(ValueError, match="no encoder weights"):
        pretrained.apply_pretrained_encoder(model, "imagenet18", stray)


def _eval_args(filelist, save_path, model_type, path, **over):
    a = types.SimpleNamespace(
        filelist=filelist, save_path=save_path, resume="",
        model_type=model_type, pretrained_path=path, head_depth=-1,
        remove_layers=["layer4"], no_l2=False, topk=5, videoLen=3,
        radius=6.0, temperature=0.05, cropSize=-1, imgSize=-1, long_mem=[0],
        texture=False, round=False, norm_mask=False, workers=0, batchSize=1,
        manualSeed=777, finetune=0, pca_vis=False, visdom=False)
    for k, v in over.items():
        setattr(a, k, v)
    return a


def _capture(monkeypatch, module):
    preds = {}
    orig = module.dump_predictions

    def dump(pred, lbl_map, img, prefix, **kw):
        preds[os.path.basename(prefix)] = np.array(pred)
        return orig(pred, lbl_map, img, prefix, **kw)

    monkeypatch.setattr(module, "dump_predictions", dump)
    return preds


@pytest.mark.parametrize("model_type", ["imagenet50", "uvc"])
def test_eval_cli_with_pretrained_type_matches_jax(files, tmp_path,
                                                   monkeypatch, capsys,
                                                   model_type):
    """``cli.test`` with ``--model-type imagenet50`` (ResNet-50, layer4
    removed: 1024-d features) or ``uvc`` (ResNet-18 in LAB) and
    ``--pretrained-path`` on a 64 px synthetic DAVIS tree: soft predictions
    within atol 1e-4 of the JAX CLI's (f32 encoders by different conv
    algorithms, then f32 propagation), as ``tests/test_torch_eval.py``."""
    from videowalk_tpu.cli.test import main as jax_main
    from videowalk_tpu.eval import test_utils as jax_tu
    from videowalk_tpu.eval.make_davis_vallist import make_list

    from videowalk_tpu_torch.cli.test import main as torch_main
    from videowalk_tpu_torch.eval import test_utils as torch_tu

    root = str(tmp_path / "DAVIS")
    make_davis_tree(root, vids=("video0",), hw=64, frames=6)
    filelist = tmp_path / "davis_vallist.txt"
    filelist.write_text("\n".join(make_list(root)) + "\n")
    want = _capture(monkeypatch, jax_tu)
    got = _capture(monkeypatch, torch_tu)
    jax_main(_eval_args(str(filelist), str(tmp_path / "jax"), model_type,
                        files[model_type]))
    torch_main(_eval_args(str(filelist), str(tmp_path / "torch"), model_type,
                          files[model_type], device="cpu"))
    out = capsys.readouterr().out
    assert f"Loaded pretrained {model_type} encoder from" in out
    assert sorted(got) == sorted(want) and len(got) == 6
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4,
                                   err_msg=name)
