"""The port's own copies of the JAX package's host utilities (palette,
color packing, checkpoint loading, unique-frame decode, prediction dumps)
against the originals: exact equality, since both are numpy on the host."""

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.data.decode import decode_unique
from videowalk_tpu_torch.eval import palette
from videowalk_tpu_torch.eval.test_utils import (dump_predictions,
                                                 infer_downscale)
from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.utils.checkpoint import (_rename_shim,
                                                  load_checkpoint,
                                                  partial_load)
from videowalk_tpu_torch.utils.colors import pack_rgb

torch.set_num_threads(1)


def test_palette_and_colors_match_jax():
    from videowalk_tpu.eval import palette as jax_palette
    from videowalk_tpu.utils.colors import pack_rgb as jax_pack

    np.testing.assert_array_equal(palette.voc_colormap(), jax_palette.voc_colormap())
    np.testing.assert_array_equal(palette.tensor, jax_palette.tensor)
    rgb = np.random.RandomState(0).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(pack_rgb(rgb), jax_pack(rgb))
    np.testing.assert_array_equal(infer_downscale(8), [8, 8])


@pytest.mark.parametrize("key", [
    "module.encoder.model.layer1.0.conv1.1.weight",
    "encoder.model.layer2.1.conv2.1.weight",
    "encoder.model.bn1.running_mean",
    "selfsim_fc.0.weight"])
def test_rename_shim_matches_jax(key):
    from videowalk_tpu.utils.checkpoint import _rename_shim as jax_shim

    assert _rename_shim(key) == jax_shim(key)


def test_partial_load_skips_and_renames(tmp_path):
    src = CRW(CRWConfig(remove_layers=("layer4",), head_depth=0))
    state = {"module." + k: v.clone() + 1.0 if v.is_floating_point() else v
             for k, v in src.state_dict().items()}
    torch.save({"model": state, "args": {"lr": 1e-4}}, tmp_path / "c.pth")
    dst = CRW(CRWConfig(remove_layers=("layer4",), head_depth=0))
    head_before = dst.selfsim_fc[0].weight.detach().clone()
    loaded = partial_load(load_checkpoint(str(tmp_path / "c.pth"))["model"],
                          dst, skip_keys=["head", "selfsim_fc"], verbose=False)
    assert "encoder.model.conv1.weight" in loaded
    assert not any("selfsim_fc" in k for k in loaded)
    torch.testing.assert_close(dst.encoder.model.conv1.weight,
                               src.encoder.model.conv1.weight + 1.0)
    torch.testing.assert_close(dst.selfsim_fc[0].weight, head_before)
    bad = {"encoder.model.conv1.weight": torch.zeros(1, 2, 3, 3)}
    with pytest.raises(ValueError, match="shape mismatch"):
        partial_load(bad, dst, verbose=False)


@pytest.mark.parametrize("workers", [0, 3])
def test_decode_unique_matches_jax(workers):
    from videowalk_tpu.data.decode import decode_unique as jax_decode

    paths = ["a", "a", "b", "c", "b"]
    got = decode_unique(paths, str.upper, workers)
    assert got == jax_decode(paths, str.upper, workers)
    assert list(got) == ["a", "b", "c"]


def test_dump_predictions_matches_jax(tmp_path):
    import cv2

    from videowalk_tpu.eval.test_utils import dump_predictions as jax_dump

    rng = np.random.RandomState(0)
    pred = rng.rand(6, 8, 3).astype(np.float32)
    img = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    lblset = np.array([[0, 0, 0], [128, 0, 0], [0, 128, 0]], np.uint8)
    blend_t, lbl_t, heat_t = dump_predictions(pred, lblset, img,
                                              str(tmp_path / "t"))
    blend_j, lbl_j, heat_j = jax_dump(pred, lblset, img, str(tmp_path / "j"))
    assert heat_t is None and heat_j is None
    np.testing.assert_array_equal(blend_t, blend_j)
    np.testing.assert_array_equal(lbl_t, lbl_j)
    for suffix in ("_blend.jpg", "_mask.png"):
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / f"t{suffix}")),
                                      cv2.imread(str(tmp_path / f"j{suffix}")))
