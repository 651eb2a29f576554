"""The port's DAVIS eval tail (``make_davis_vallist``, ``convert_davis``,
``davis_metrics``, ``dump_predictions`` with ``heatmap`` and
``img_is_unit_scale``) against the JAX package's, and the whole chain
``cli.test`` -> ``convert_all`` -> ``evaluate_davis`` of both packages on one
synthetic DAVIS tree and one ``.pth`` (``tests/_synth``). The modules are
held exactly; the chain's soft predictions agree to atol 1e-4 (as
``tests/test_torch_eval.py`` holds the eval slice), and with every
converted mask equal the J&F is equal."""

import os
import types

import numpy as np
import pytest
import torch

from PIL import Image

from videowalk_tpu.eval import convert_davis as jcd
from videowalk_tpu.eval import make_davis_vallist as jmv

from videowalk_tpu_torch.eval import convert_davis as tcd
from videowalk_tpu_torch.eval import make_davis_vallist as tmv

from _synth import make_crw_checkpoint, make_davis_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def davis(tmp_path_factory):
    return make_davis_tree(str(tmp_path_factory.mktemp("DAVIS")), hw=64,
                           frames=8)


def test_make_list_equals_jax(davis, tmp_path):
    assert tmv.make_list(davis) == jmv.make_list(davis)
    out = tmp_path / "list.txt"
    tmv.main(["--davis", davis, "--out", str(out)])
    assert out.read_text() == "\n".join(jmv.make_list(davis)) + "\n"


def test_color2id_map_equals_jax():
    rng = np.random.RandomState(0)
    pal = tcd.PALETTE
    np.testing.assert_array_equal(pal, jcd.PALETTE)
    img = pal[rng.randint(0, 256, (48, 80))]
    img[rng.rand(48, 80) < 0.2] = rng.randint(0, 256, (3,))  # off-palette
    np.testing.assert_array_equal(tcd.color2id_map(img),
                                  jcd.color2id_map(img))
    assert tcd.color2id_map(pal[None, :, :]).tolist() == [list(range(256))]


def test_convert_all_writes_the_jax_modules_pngs(davis, tmp_path):
    """Masks as ``dump_predictions`` writes them (``{vid}_{j}_mask.png``,
    palette colors in RGB, at another size than the annotations): the
    converted PNGs' bytes, ids and palette equal the JAX module's."""
    import imageio

    rng = np.random.RandomState(1)
    masks = tmp_path / "masks"
    masks.mkdir()
    for v in range(2):
        for j in range(8):
            ids = rng.randint(0, 3, (24, 40))
            imageio.imwrite(masks / f"{v}_{j}_mask.png",
                            tcd.PALETTE[ids].astype(np.uint8))
    got = tcd.convert_all(str(masks), str(tmp_path / "port"), davis)
    want = jcd.convert_all(str(masks), str(tmp_path / "jax"), davis)
    assert got == want == ["video0", "video1"]
    for v in want:
        names = sorted(os.listdir(tmp_path / "jax" / v))
        assert sorted(os.listdir(tmp_path / "port" / v)) == names
        assert len(names) == 8
        for n in names:
            a, b = tmp_path / "port" / v / n, tmp_path / "jax" / v / n
            assert a.read_bytes() == b.read_bytes()
            ia, ib = Image.open(a), Image.open(b)
            assert ia.mode == ib.mode == "P" and ia.size == (64, 64)
            assert ia.getpalette() == ib.getpalette()
            np.testing.assert_array_equal(np.array(ia), np.array(ib))


def _args(filelist, save_path, ckpt, **over):
    a = types.SimpleNamespace(
        filelist=filelist, save_path=save_path, resume=ckpt,
        model_type="scratch", head_depth=-1, remove_layers=["layer4"],
        no_l2=False, topk=5, videoLen=3, radius=6.0, temperature=0.05,
        cropSize=-1, imgSize=-1, long_mem=[0], texture=False, round=False,
        norm_mask=False, workers=0, batchSize=1, manualSeed=777, finetune=0,
        pca_vis=False, visdom=False)
    for k, v in over.items():
        setattr(a, k, v)
    return a


def test_chain_gives_the_jax_chains_jf(davis, tmp_path, monkeypatch):
    """``cli.test`` -> ``convert_all`` -> ``evaluate_davis`` of the port
    (``--device cpu``) and of the JAX package on the same tree and
    ``.pth``: soft predictions within 1e-4, the converted masks equal on
    every pixel, and so the same J&F dict."""
    from videowalk_tpu.cli.test import main as jax_main
    from videowalk_tpu.eval import test_utils as jax_tu
    from videowalk_tpu.eval.davis_metrics import evaluate_davis as jax_eval

    from videowalk_tpu_torch.cli.test import main as torch_main
    from videowalk_tpu_torch.eval import test_utils as torch_tu
    from videowalk_tpu_torch.eval.davis_metrics import evaluate_davis

    lst = tmp_path / "davis_vallist.txt"
    lst.write_text("\n".join(tmv.make_list(davis)) + "\n")
    ckpt = make_crw_checkpoint(str(tmp_path / "model.pth"), "scratch", seed=5)
    preds = {}
    for name, mod in (("jax", jax_tu), ("port", torch_tu)):
        orig = mod.dump_predictions
        got = preds[name] = {}

        def dump(pred, lbl_map, img, prefix, _orig=orig, _got=got, **kw):
            _got[os.path.basename(prefix)] = np.array(pred)
            return _orig(pred, lbl_map, img, prefix, **kw)

        monkeypatch.setattr(mod, "dump_predictions", dump)
    jax_main(_args(str(lst), str(tmp_path / "jax"), ckpt))
    torch_main(_args(str(lst), str(tmp_path / "port"), ckpt, device="cpu"))
    assert sorted(preds["port"]) == sorted(preds["jax"])
    for k, want in preds["jax"].items():
        np.testing.assert_allclose(preds["port"][k], want, atol=1e-4)

    tcd.convert_all(str(tmp_path / "port"), str(tmp_path / "port_c"), davis)
    jcd.convert_all(str(tmp_path / "jax"), str(tmp_path / "jax_c"), davis)
    for v in ("video0", "video1"):
        for f in sorted(os.listdir(tmp_path / "jax_c" / v)):
            np.testing.assert_array_equal(
                np.array(Image.open(tmp_path / "port_c" / v / f)),
                np.array(Image.open(tmp_path / "jax_c" / v / f)))
    got = evaluate_davis(str(tmp_path / "port_c"), davis)
    assert got == jax_eval(str(tmp_path / "jax_c"), davis)
    assert 0.0 < got["J&F-Mean"] <= 1.0


@pytest.mark.parametrize("img_kind,unit,heatmap", [
    ("uint8", None, False), ("unit_float", None, True),
    ("unit_float", True, False), ("float_255", False, True),
    ("dark_float_255", None, False)])
def test_dump_predictions_equals_jax(tmp_path, img_kind, unit, heatmap):
    """The same soft labels, frame and flags through both
    ``dump_predictions``: the blend, mask colors and heatmap returned
    equal, the blend jpg and mask png byte-identical; the VIP path's
    ``.jpg`` prefix (with ``jpg`` in a directory name) as well."""
    from videowalk_tpu.eval.test_utils import dump_predictions as jax_dump

    from videowalk_tpu_torch.eval.test_utils import dump_predictions

    rng = np.random.RandomState(2)
    pred = rng.rand(6, 10, 3).astype(np.float32)
    lbl_set = np.array([[0, 0, 0], [128, 0, 0], [0, 128, 0]], np.uint8)
    img = {"uint8": rng.randint(0, 255, (48, 80, 3)).astype(np.uint8),
           "unit_float": rng.rand(48, 80, 3).astype(np.float32),
           "float_255": rng.rand(48, 80, 3).astype(np.float32) * 255,
           "dark_float_255": rng.rand(48, 80, 3).astype(np.float32)}[img_kind]
    for sub in ("flat", "jpg_dir/videos1"):
        outs = {}
        for name, fn in (("port", dump_predictions), ("jax", jax_dump)):
            d = tmp_path / name / sub
            d.mkdir(parents=True)
            prefix = str(d / ("000007.jpg" if "/" in sub else "0_3"))
            outs[name] = fn(pred, lbl_set, img, prefix, heatmap=heatmap,
                            img_is_unit_scale=unit)
        for a, b in zip(outs["port"], outs["jax"]):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
        assert (outs["port"][2] is not None) == heatmap
        files = sorted(os.listdir(tmp_path / "jax" / sub))
        assert sorted(os.listdir(tmp_path / "port" / sub)) == files
        assert len(files) == 2
        for f in files:
            assert (tmp_path / "port" / sub / f).read_bytes() == \
                (tmp_path / "jax" / sub / f).read_bytes()
