"""The port's ``utils/visualize.py`` against the JAX package's
``videowalk_tpu/utils/visualize.py``: the JSON lines ``Visualize`` writes
without wandb (equal but for the ``t`` timestamp), ``make_grid``,
``compute_flow``, ``_mark_boundaries``, ``make_gif`` and ``draw_matches``
(exact); ``frame_pair``, ``vis_adj`` and ``nn_patches`` write their
figures, on numpy arrays and on CPU tensors."""

import json
import os
import types

import numpy as np
import pytest
import torch

import videowalk_tpu.utils.visualize as JV

import videowalk_tpu_torch.utils.visualize as V

torch.set_num_threads(1)


def _records(path):
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    for r in recs:
        assert isinstance(r.pop("t"), float)
    return recs


def test_jsonl_lines_equal_the_jax_package(tmp_path, monkeypatch):
    monkeypatch.setattr(JV, "_wandb", None)
    monkeypatch.setattr(V, "_wandb", lambda: None)
    logs = [dict(loss=1.25), {"xent cyc r1": np.float32(0.5),
                              "acc cyc r1": np.asarray(0.75)},
            dict(note="warm", step=3, lr=3e-4)]
    out = {}
    for name, M in (("jax", JV), ("port", V)):
        args = types.SimpleNamespace(name="run", logs_dir=str(tmp_path / name))
        vis = M.Visualize(args)
        vis.wandb_init()
        for rec in logs:
            vis.log(rec)
        out[name] = _records(tmp_path / name / "metrics.jsonl")
    assert out["port"] == out["jax"]
    assert out["port"][2] == {"note": "warm", "step": 3.0, "lr": 3e-4}
    # a tensor logs as its value; close() ends the file, a new logger appends
    vis = V.Visualize(types.SimpleNamespace(logs_dir=str(tmp_path / "port")))
    vis.log(dict(loss=torch.tensor(2.0)))
    vis.close()
    assert _records(tmp_path / "port" / "metrics.jsonl")[-1] == {"loss": 2.0}


def test_array_helpers_equal_the_jax_package():
    rng = np.random.RandomState(0)
    imgs = rng.rand(5, 3, 6, 7).astype(np.float32)
    for nrow, pad in ((2, 1), (3, 0), (5, 2)):
        np.testing.assert_array_equal(V.make_grid(imgs, nrow, pad),
                                      JV.make_grid(imgs, nrow, pad))
    np.testing.assert_array_equal(V.make_grid(torch.from_numpy(imgs), 2),
                                  JV.make_grid(imgs, 2))
    corr = rng.rand(2, 16, 16).astype(np.float32)
    for got, want in zip(V.compute_flow(corr), JV.compute_flow(corr)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(V.compute_flow(torch.from_numpy(corr)),
                         JV.compute_flow(corr)):
        np.testing.assert_array_equal(got, want)
    seg = rng.randint(0, 4, (12, 12))
    for img in (rng.rand(12, 12, 3), rng.randint(0, 256, (12, 12, 3))):
        np.testing.assert_array_equal(V._mark_boundaries(img, seg),
                                      JV._mark_boundaries(img, seg))
    video = rng.rand(3, 3, 20, 24).astype(np.float32)
    np.testing.assert_array_equal(V.make_gif(video, None, 32),
                                  JV.make_gif(video, None, 32))
    # cv2.drawMatches colours each match from cv2's own generator
    import cv2

    x1, x2 = rng.rand(8, 16), rng.rand(8, 16)
    i1, i2 = rng.rand(3, 20, 20), rng.rand(3, 20, 20)
    cv2.setRNGSeed(3)
    got = V.draw_matches(x1, x2, i1, i2)
    cv2.setRNGSeed(3)
    np.testing.assert_array_equal(got, JV.draw_matches(x1, x2, i1, i2))


def test_gif_file(tmp_path):
    video = np.random.RandomState(1).randint(0, 256, (3, 16, 16, 3), np.uint8)
    V.make_gif(video, str(tmp_path / "a.gif"), 16)
    assert os.path.getsize(tmp_path / "a.gif") > 0


@pytest.mark.parametrize("as_tensor", [False, True])
def test_figures_are_written(tmp_path, as_tensor):
    rng = np.random.RandomState(2)
    t = torch.from_numpy if as_tensor else np.asarray
    vis = V.Visualize(types.SimpleNamespace(logs_dir=str(tmp_path)))
    # whole-image walk panel: 16 nodes (4x4 maps)
    x = rng.rand(1, 4, 32, 32, 3).astype(np.float32)
    mm = rng.rand(1, 4, 4, 4, 8).astype(np.float32)
    A = rng.rand(2, 16, 16).astype(np.float32)
    AA = rng.rand(1, 16, 16).astype(np.float32)
    V.frame_pair(t(x), None, t(mm), 0, 1, t(A), t(AA),
                 t(rng.rand(16).astype(np.float32)), vis)
    # patch input: PCA grids of the patches' maps
    xp = rng.rand(1, 4, 9, 16, 16, 3).astype(np.float32)
    mp = rng.rand(1, 4, 9, 2, 2, 8).astype(np.float32)
    V.frame_pair(t(xp), None, t(mp), 1, 2, t(A), t(rng.rand(1, 9, 9)
                                                   .astype(np.float32)),
                 t(rng.rand(9).astype(np.float32)), vis)
    seg = rng.randint(0, 5, (2, 16, 16))
    path = V.vis_adj(t(rng.rand(2, 16, 16, 3)), t(seg),
                     [rng.rand(5, 5), rng.rand(5, 5)], vis,
                     t(rng.rand(2, 3, 16, 16).astype(np.float32)))
    V.nn_patches(vis, rng.rand(6, 3, 8, 8), rng.rand(1, 6, 6), "p", N=2, K=3)
    names = set(os.listdir(tmp_path))
    assert path == str(tmp_path / "superpixel_adj.png")
    assert {"flow_quiver_0_1.png", "pcafeats_0_1.png", "lossvis_0_1.png",
            "pca_patches_1.png", "pca_patches_2.png", "superpixel_adj.png",
            "adjacency_heatmaps.png", "p_patch_values_0_0.png",
            "p_patch_values_1_0.png"} <= names
    assert all(os.path.getsize(tmp_path / n) > 0 for n in names)
