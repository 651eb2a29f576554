"""The port's ``ImageFolder`` (``videowalk_tpu_torch/data/image_folder.py``)
against the JAX package's (``videowalk_tpu/data/image_folder.py``): the same
tree of seeded JPEGs and seed give bitwise the same items, views and host
superpixel ids alike; ``is_image_folder`` also imports from
``data.kinetics`` as before. Everything exact."""

import numpy as np
import pytest
import torch

from videowalk_tpu.data import augs as jaugs
from videowalk_tpu.data.image_folder import (ImageFolder as JaxImageFolder,
                                             is_image_folder as jax_is_folder)

from videowalk_tpu_torch.data import augs
from videowalk_tpu_torch.data.image_folder import (ImageFolder,
                                                   is_image_folder, read_rgb)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("imgs") / "image_synth"
    for ci, cls in enumerate(("a", "b")):
        (root / cls).mkdir(parents=True)
        rng = np.random.RandomState(ci)
        for i in range(3):
            img = np.kron(rng.randint(0, 255, (9, 9, 3)),
                          np.ones((8, 8, 1))).astype(np.uint8)
            cv2.imwrite(str(root / cls / f"img{i}.jpg"), img)
    (root / "a" / "notes.txt").write_text("not an image")
    return str(root)


@pytest.mark.parametrize("sp", [
    dict(sp_method="none"),
    dict(sp_method="slic", num_components=9),
    dict(sp_method="random", num_components=9, prob=0.5,
         randomise_superpixels=True, randomise_superpixels_range=4),
], ids=["none", "slic", "random"])
def test_items_equal_the_jax_package(folder, sp):
    dsets = []
    for K, T in ((JaxImageFolder, jaugs), (ImageFolder, augs)):
        tf = T.TrainTransform(img_size=64, frame_transforms="crop,cj,flip",
                              frame_aug="grid", patch_size=(16, 16, 3))
        ds = K(folder, clip_len=3, transform=tf, seed=4, **sp)
        ds.set_compactness(30)
        dsets.append(ds)
    jds, pds = dsets
    assert len(pds) == len(jds) == 6 and pds.samples == jds.samples
    assert pds.classes == ["a", "b"]
    for i in range(len(pds)):
        (jv, jm, jl), (pv, pm, pl) = jds[i], pds[i]
        assert pl == jl
        assert set(pv) == set(jv) == {"grid", "whole", "whole_unnorm"}
        for k in jv:
            np.testing.assert_array_equal(pv[k], jv[k])
        assert pm.dtype == np.int32
        np.testing.assert_array_equal(pm, jm)
        if sp["sp_method"] != "none":
            assert pm.shape == (3, 64, 64)


def test_the_array_core_and_the_file_shell(folder):
    """``item`` on the decoded image gives ``__getitem__``'s item; without
    a transform the clip is the image repeated; a missing file raises."""
    ds = ImageFolder(folder, clip_len=2, seed=1)
    path, label = ds.samples[4]
    img = read_rgb(path)
    assert img.dtype == np.uint8 and img.shape == (72, 72, 3)
    views, mask = ds.item(img, 4)
    got = ds[4]
    assert got[2] == label == 1 and mask.shape == (0,)
    for k, v in views.items():
        np.testing.assert_array_equal(v, got[0][k])
        np.testing.assert_array_equal(v, np.stack([img, img]))
    with pytest.raises(IOError, match="could not read"):
        read_rgb(path + ".missing.jpg")
    with pytest.raises(FileNotFoundError, match="no images"):
        ImageFolder(folder + "/a")          # files, no class folders


def test_is_image_folder_imports_from_kinetics_too(folder, tmp_path):
    from videowalk_tpu_torch.data.kinetics import (
        is_image_folder as from_kinetics)

    assert from_kinetics is is_image_folder
    (tmp_path / "vids" / "c").mkdir(parents=True)
    (tmp_path / "vids" / "c" / "v.mp4").write_bytes(b"")
    for root in (folder, str(tmp_path / "vids"), str(tmp_path / "none")):
        assert is_image_folder(root) == jax_is_folder(root)
    assert is_image_folder(folder) and not is_image_folder(
        str(tmp_path / "vids"))
