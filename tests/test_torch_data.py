"""The port's host data layer (``videowalk_tpu_torch/data``: ``clips``,
``kinetics``, ``video``, ``loader``, ``augs``) against the JAX package's
(``videowalk_tpu/data``): the same synthetic Kinetics tree and seeds give
bitwise the same batches, transforms, samplers and metadata caches."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from videowalk_tpu.data import augs as jaugs
from videowalk_tpu.data.clips import (RandomClipSampler as JaxSampler,
                                      UniformClipSampler as JaxUniform,
                                      VideoClipIndex as JaxIndex)
from videowalk_tpu.data.kinetics import Kinetics400 as JaxKinetics
from videowalk_tpu.data.loader import DataLoader as JaxLoader
from videowalk_tpu.data.video import (SingleVideoDataset as JaxSingle,
                                      VideoList as JaxVideoList)

from videowalk_tpu_torch.data import augs
from videowalk_tpu_torch.data.clips import (RandomClipSampler,
                                            UniformClipSampler,
                                            VideoClipIndex)
from videowalk_tpu_torch.data.kinetics import Kinetics400, is_image_folder
from videowalk_tpu_torch.data.loader import DataLoader
from videowalk_tpu_torch.data.video import SingleVideoDataset, VideoList

from _synth import make_kinetics_tree

torch.set_num_threads(1)

# (frame_transforms, frame_aug): the config of record's and every option
TRANSFORMS = [("crop", "grid"), ("crop,cj,flip", "grid,cj,flip"),
              ("cj", "")]


@pytest.fixture(scope="module")
def kinetics_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kin"))
    make_kinetics_tree(root)
    return os.path.join(root, "val_256")


def _datasets(root, transforms):
    """(JAX, port) Kinetics400 over ``root`` with clips of 4 frames at 8
    fps, their samplers and 2-clip loaders, both at epoch 1."""
    out = []
    for K, S, L, T in ((JaxKinetics, JaxSampler, JaxLoader, jaugs),
                       (Kinetics400, RandomClipSampler, DataLoader, augs)):
        tf = (T.RawClipTransform(64) if transforms == "raw" else
              T.TrainTransform(img_size=64, frame_transforms=transforms[0],
                               frame_aug=transforms[1],
                               patch_size=(16, 16, 3)))
        ds = K(root, frames_per_clip=4, frame_rate=8, transform=tf,
               sp_method="none", seed=3)
        ds.set_epoch(1)
        out.append(L(ds, batch_size=2, sampler=S(ds.video_clips, 2, seed=3),
                     num_workers=2))
    return out


@pytest.mark.parametrize("transforms", TRANSFORMS + ["raw"],
                         ids=lambda t: t if isinstance(t, str) else "-".join(t))
def test_batches_equal_the_jax_package(kinetics_root, transforms):
    """Kinetics400 + RandomClipSampler + DataLoader: every batch of an
    epoch (views and labels) is bitwise the JAX package's."""
    jl, pl = _datasets(kinetics_root, transforms)
    assert len(jl) == len(pl) == 4
    jb, pb = list(jl), list(pl)
    assert len(jb) == len(pb) == 4
    for (jv, jm, jlab), (pv, pm, plab) in zip(jb, pb):
        assert sorted(jv) == sorted(pv)
        for k in jv:
            assert jv[k].dtype == pv[k].dtype and jv[k].shape == pv[k].shape
            np.testing.assert_array_equal(jv[k], pv[k])
        np.testing.assert_array_equal(jlab, plab)
        assert pm.shape == (2, 0) and pm.dtype == np.int32


@pytest.mark.parametrize("transforms", TRANSFORMS,
                         ids=lambda t: "-".join(t))
def test_train_transform_bitwise_at_one_random_state(transforms):
    """``TrainTransform`` on one clip at one ``RandomState``: the three
    views equal the JAX package's bit for bit, and the stream ends at the
    same state."""
    clip = np.random.RandomState(0).randint(0, 256, (3, 72, 80, 3), np.uint8)
    outs, tails = [], []
    for T in (jaugs, augs):
        rng = np.random.RandomState(11)
        tf = T.TrainTransform(img_size=64, frame_transforms=transforms[0],
                              frame_aug=transforms[1], patch_size=(32, 32, 3))
        outs.append(tf(clip, rng=rng))
        tails.append(rng.random_sample())
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    assert tails[0] == tails[1]
    assert outs[1]["grid"].shape == ((3, 9, 32, 32, 3) if transforms[1]
                                     else (3, 64, 64, 3))


def test_get_train_transforms_follows_the_flags():
    import types

    args = types.SimpleNamespace(img_size=48, frame_transforms="crop,flip",
                                 frame_aug="grid", patch_size=[16, 16, 3],
                                 seed=5)
    a, b = jaugs.get_train_transforms(args), augs.get_train_transforms(args)
    clip = np.random.RandomState(1).randint(0, 256, (2, 50, 50, 3), np.uint8)
    out = b(clip)
    for k, v in a(clip).items():
        np.testing.assert_array_equal(v, out[k])


def test_metadata_cache_reads_both_ways(kinetics_root, tmp_path):
    """A cache written by either package builds the other's clip index with
    the same clips; a cache of another tree is refused."""
    ds = Kinetics400(kinetics_root, frames_per_clip=4, frame_rate=8,
                     sp_method="none")
    paths = ds.video_list
    for Writer, Reader in ((VideoClipIndex, JaxIndex),
                           (JaxIndex, VideoClipIndex)):
        src = Writer(paths, 4, 1, 8)
        path = str(tmp_path / f"{Writer.__module__}.pkl")
        src.save_metadata(path)
        dst = Reader(paths, 4, 1, 8, _metadata=Reader.load_metadata(path))
        assert dst.cumulative == src.cumulative
        for a, b in zip(dst.clips, src.clips):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="does not match"):
            Reader(paths[::-1], 4, _metadata=Reader.load_metadata(path))


def test_clip_index_and_samplers_match_the_jax_package(kinetics_root):
    ds = Kinetics400(kinetics_root, frames_per_clip=4, frame_rate=8,
                     sp_method="none")
    jidx = JaxIndex(ds.video_list, 4, 2, 12)
    pidx = VideoClipIndex(ds.video_list, 4, 2, 12)
    assert pidx.cumulative == jidx.cumulative
    for i in (0, 5, pidx.num_clips() - 1):
        assert pidx.get_clip_location(i) == jidx.get_clip_location(i)
        np.testing.assert_array_equal(pidx.get_clip(i)[0], jidx.get_clip(i)[0])
    with pytest.raises(IndexError):
        pidx.get_clip(-1)
    for n in (1, 3):
        assert list(UniformClipSampler(pidx, n)) == list(JaxUniform(jidx, n))
        ps, js = RandomClipSampler(pidx, n, seed=4), JaxSampler(jidx, n, seed=4)
        for _ in range(2):                     # two passes of one stream
            assert list(ps) == list(js)
        assert len(ps) == len(js)


def test_loader_reraises_a_producer_exception():
    class Flaky:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("bad item 5")
            return np.full((2,), i, np.float32), i

    seen = []
    with pytest.raises(KeyError, match="bad item 5"):
        for x, i in DataLoader(Flaky(), batch_size=2, num_workers=2):
            seen.append(i.tolist())
    assert seen == [[0, 1], [2, 3]]


@pytest.mark.parametrize("world", [1, 2, 3])
def test_shard_splits_as_the_jax_package(world):
    """``shard=(rank, world)``: each rank's indices and length equal the
    JAX loader's, the shards are disjoint and equally long."""
    data = list(range(23))
    got = []
    for rank in range(world):
        kw = dict(batch_size=2, num_workers=1, shard=(rank, world))
        p, j = DataLoader(data, **kw), JaxLoader(data, **kw)
        assert p._indices() == j._indices() and len(p) == len(j)
        assert [b.tolist() for b in p] == [b.tolist() for b in j]
        got.append(p._indices())
    assert len({len(g) for g in got}) == 1
    assert len(set(sum(got, []))) == sum(len(g) for g in got)
    with pytest.raises(ValueError):
        DataLoader(data, 2, shard=(world, world))


def test_frame_folder_datasets_match_the_jax_package(tmp_path):
    """``VideoList`` over a JPEG filelist (with the frame-gap shrink) and
    ``SingleVideoDataset``: the port's items equal the JAX package's."""
    import cv2

    rng = np.random.RandomState(0)
    lines = []
    for v, n in (("v0", 12), ("v1", 6)):
        d = tmp_path / v
        d.mkdir()
        for t in range(n):
            cv2.imwrite(str(d / f"{t:05d}.jpg"),
                        rng.randint(0, 256, (24, 32, 3), np.uint8))
        lines.append(f"{d} {n}")
    fl = tmp_path / "list.txt"
    fl.write_text("\n".join(lines) + "\n")
    tf = [T.TrainTransform(img_size=16, frame_aug="") for T in (jaugs, augs)]
    j = JaxVideoList(str(fl), clip_len=4, frame_gap=2, transform=tf[0], seed=1)
    p = VideoList(str(fl), clip_len=4, frame_gap=2, transform=tf[1], seed=1)
    for ds in (j, p):
        ds.set_epoch(2)
    for i in range(len(p)):
        for k, v in j[i][0].items():
            np.testing.assert_array_equal(v, p[i][0][k])
    video = rng.randint(0, 256, (20, 8, 8, 3), np.uint8)
    js, pv = JaxSingle(video, 4, (1, 3), seed=2), SingleVideoDataset(
        video, 4, (1, 3), seed=2)
    for i in range(6):
        np.testing.assert_array_equal(js[i], pv[i])


def test_image_folder_is_detected(tmp_path, kinetics_root):
    import cv2

    (tmp_path / "cls").mkdir()
    cv2.imwrite(str(tmp_path / "cls" / "a.jpg"), np.zeros((4, 4, 3), np.uint8))
    assert is_image_folder(str(tmp_path))
    assert not is_image_folder(kinetics_root)


def test_host_rejects_host_superpixels(kinetics_root):
    with pytest.raises(NotImplementedError, match="sp_backend='host'"):
        Kinetics400(kinetics_root, 4, sp_method="slic", sp_backend="host")


def test_the_data_layer_imports_cv2_lazily():
    """The card's machine has no cv2: importing the port's data layer, its
    device augmentations and the trainer must not import it."""
    code = ("import sys\n"
            "import videowalk_tpu_torch.data.clips, "
            "videowalk_tpu_torch.data.kinetics, "
            "videowalk_tpu_torch.data.video, videowalk_tpu_torch.data.augs, "
            "videowalk_tpu_torch.data.prefetch, "
            "videowalk_tpu_torch.ops.augs_device, "
            "videowalk_tpu_torch.cli.train\n"
            "assert 'cv2' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                   check=True, timeout=120)
