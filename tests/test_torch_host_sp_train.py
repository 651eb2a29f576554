"""Superpixel training from host masks (``--sp-backend host``) on the CPU
against the JAX package:

- a ``Kinetics400(sp_backend="host")`` item's ids equal the JAX dataset's
  bitwise at the same seed and epoch (SLIC, FH and the per-clip mix, with
  randomized segment counts);
- the superpixel step on Felzenszwalb masks whose ids reach past the node
  slots (``max_sp_num``): both packages drop those ids (they match no slot),
  and the port's q and loss (f32) and every gradient (f64) equal JAX's
  within ``tests/test_torch_superpixel.py``'s tolerances: q atol 1e-4, loss
  rtol 1e-4, gradients 3e-5 of each tensor's largest entry;
- ``cli.train`` with ``--prob 0.5 --sp-backend host --sp-method random`` on
  the synthetic Kinetics tree, and on an image folder, takes its 2 steps,
  and each superpixel step gets exactly the loader's ids (no SLIC on the
  device)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu.data import augs as jaugs
from videowalk_tpu.data.kinetics import Kinetics400 as JaxKinetics
from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig
from videowalk_tpu.models.crw import superpixel_pool_weights as jax_weights

from videowalk_tpu_torch.cli import train as cli
from videowalk_tpu_torch.data import augs
from videowalk_tpu_torch.data.kinetics import Kinetics400
from videowalk_tpu_torch.data.superpixels import compute_sp_FH
from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.models.crw import superpixel_pool_weights
from videowalk_tpu_torch.utils.arguments import train_args
from videowalk_tpu_torch.utils.checkpoint import state_from_flax

from _synth import make_kinetics_tree
from test_torch_superpixel import _jax_loss_fn, _jax_masks, _np

torch.set_num_threads(1)

SLOTS, TEMP, RATE = 8, 0.05, 0.1


@pytest.fixture(scope="module")
def kinetics_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kin"))
    make_kinetics_tree(root)
    return os.path.join(root, "val_256")


@pytest.mark.parametrize("method", ["slic", "fh", "random"])
def test_host_masks_equal_the_jax_dataset(kinetics_root, method):
    items = []
    for K, T in ((JaxKinetics, jaugs), (Kinetics400, augs)):
        tf = T.TrainTransform(img_size=64, frame_transforms="crop,cj",
                              frame_aug="grid", patch_size=(16, 16, 3))
        ds = K(kinetics_root, 4, frame_rate=8, transform=tf,
               sp_method=method, num_components=9, prob=0.5,
               randomise_superpixels=True, randomise_superpixels_range=4,
               sp_backend="host", seed=5)
        ds.set_compactness(30)
        ds.set_epoch(2)
        items.append([ds[i] for i in range(0, len(ds), 7)])
    for (jv, jm, jl), (pv, pm, pl) in zip(*items):
        assert pl == jl and pm.shape == (4, 64, 64) and pm.dtype == np.int32
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(pv["whole_unnorm"], jv["whole_unnorm"])


def fh_ids(B, T, h, seed):
    """``(B, T, h, h)`` FH ids of seeded block frames, at a scale that
    gives more segments than the ``SLOTS`` node slots; and the frames."""
    rng = np.random.RandomState(seed)
    cell = h // 4
    frames = np.kron(rng.rand(B, T, 4, 4, 3),
                     np.ones((1, 1, cell, cell, 1)))
    frames = (frames + 0.02 * rng.randn(*frames.shape)).clip(0, 1)
    ids = np.stack([[compute_sp_FH(f, scale=2.0, min_size=cell) for f in clip]
                    for clip in frames]).astype(np.int32)
    return frames.astype(np.float32), ids


def _configs(dilate, **kw):
    cfg = dict(model_type="scratch", temperature=TEMP, max_sp_num=SLOTS,
               dilate_superpixels=dilate, dilation_kernel_size=7,
               edgedrop_rate=RATE, **kw)
    return JaxConfig(**cfg), cfg


@pytest.mark.parametrize("dilate", [False, True])
def test_ids_past_the_slots_drop_as_in_jax(dilate):
    x, sp = fh_ids(2, 4, 64, seed=0)
    assert sp.max() >= SLOTS and (sp < SLOTS).any()
    kw = dict(dilate=dilate, dilation_kernel_size=7)
    want = np.asarray(jax_weights(jnp.asarray(sp), SLOTS, (8, 8), **kw))
    got = superpixel_pool_weights(torch.from_numpy(sp), SLOTS, (8, 8), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the ids past the slots weigh nothing: each present slot sums to 1
    cols = got.sum((2, 3)).numpy()
    assert ((np.abs(cols - 1) < 1e-5) | (cols == 0)).all()

    jcfg, cfg = _configs(dilate)
    jm = JaxCRW(jcfg)
    variables = _np(dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 sp_mask=jnp.asarray(sp), train=False)))
    key = jax.random.PRNGKey(4)
    loss_j, (q_j, _, _) = jax.jit(_jax_loss_fn(jm, variables, x, sp, key))(
        variables["params"])
    model = CRW(CRWConfig(**cfg))
    model.load_state_dict(state_from_flax(variables), strict=True)
    with torch.no_grad():
        q, loss, _ = model(torch.from_numpy(x), sp_mask=torch.from_numpy(sp),
                           train=True,
                           walk_masks=_jax_masks(key, (3, 2, SLOTS, SLOTS)))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=1e-4)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)


def test_grads_on_fh_ids_match_jax_in_float64():
    """Through the dilation (#11's plain version), whose one-hot compares
    against the slots; the window counts' path is held by the forward
    test above."""
    jcfg, cfg = _configs(True, fused_walk="off")
    x, sp = fh_ids(2, 4, 32, seed=1)
    x = x.astype(np.float64)
    assert sp.max() >= SLOTS
    variables = _np(dict(JaxCRW(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32),
        sp_mask=jnp.asarray(sp), train=False)))
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        jm = JaxCRW(JaxConfig(dtype=jnp.float64, **cfg))
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        grads_j = _np(jax.jit(jax.grad(
            lambda p: _jax_loss_fn(jm, v64, jnp.asarray(x), jnp.asarray(sp),
                                   key)(p)[0]))(v64["params"]))
        masks = _jax_masks(key, (3, 2, SLOTS, SLOTS))
    grads = state_from_flax({"params": grads_j})
    model = CRW(CRWConfig(dtype=torch.float64, **cfg))
    model.load_state_dict(state_from_flax(variables), strict=True)
    model.double()
    _, loss, _ = model(torch.from_numpy(x), sp_mask=torch.from_numpy(sp),
                       train=True, walk_masks=masks)
    loss.backward()
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for k, g in grads.items():
        g = g.double().numpy()
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=0,
                                   atol=3e-5 * np.abs(g).max(), err_msg=k)


def _argv(data, out, *extra):
    return ["--device", "cpu", "--data-path", data, "--frame-aug", "grid",
            "--clip-len", "4", "--temp", "0.05", "--dropout", "0.1",
            "--model-type", "scratch_zeropad", "--remove-layers", "layer4",
            "--img-size", "64", "--patch-size", "16", "16", "3",
            "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "2",
            "--workers", "2", "--print-freq", "1", "--prob", "0.5",
            "--sp-backend", "host", "--num-sp", "9", "--compactness", "30",
            "--max-sp-num", "12", "--output-dir", out,
            "--logs-dir", os.path.join(out, "logs"),
            "--cache-path", os.path.join(out, "cache.pt"), *extra]


def _both_paths_seed() -> int:
    """A seed whose epoch-0 draws (path choice, then checkpoint coin, per
    step) take a patch and a superpixel step in the first two."""
    for seed in range(50):
        rs = np.random.RandomState(seed)
        paths = []
        for _ in range(2):
            paths.append(bool(rs.choice([True, False], p=[0.5, 0.5])))
            rs.random_sample()
        if set(paths) == {True, False}:
            return seed
    raise AssertionError("no seed takes both paths")


@pytest.fixture
def recorded(monkeypatch):
    """Record each batch's ids as the loader yields them and the ids each
    step gets; SLIC on the device must not run."""
    rec = {"loader": [], "step": []}

    class Loader(cli.DataLoader):
        def __iter__(self):
            for batch in super().__iter__():
                rec["loader"].append(np.array(batch[1]))
                yield batch

    real = cli.make_train_step

    def make_train_step():
        step = real()

        def wrapped(state, batch, gen, sp_mask=None):
            rec["step"].append(None if sp_mask is None
                               else sp_mask.cpu().numpy())
            return step(state, batch, gen, sp_mask=sp_mask)
        return wrapped

    def no_slic(*a, **k):
        raise AssertionError("device SLIC ran under --sp-backend host")

    monkeypatch.setattr(cli, "DataLoader", Loader)
    monkeypatch.setattr(cli, "make_train_step", make_train_step)
    monkeypatch.setattr(cli, "slic_fused", no_slic)
    return rec


def _check_consumed(rec):
    sp_steps = [i for i, m in enumerate(rec["step"]) if m is not None]
    assert len(rec["step"]) == 2 and sp_steps
    for i in sp_steps:
        assert rec["loader"][i].shape == (2, 4, 64, 64)
        np.testing.assert_array_equal(rec["step"][i], rec["loader"][i])
    return sp_steps


def test_cli_trains_on_host_masks(kinetics_root, tmp_path, recorded):
    seed = _both_paths_seed()
    state = cli.main(train_args(_argv(
        kinetics_root, str(tmp_path / "o"), "--sp-method", "random",
        "--seed", str(seed))))
    assert state.step == 2
    _check_consumed(recorded)


def test_cli_trains_on_an_image_folder(tmp_path, recorded):
    import cv2

    root = tmp_path / "images"
    for ci, cls in enumerate(("a", "b")):
        (root / cls).mkdir(parents=True)
        rng = np.random.RandomState(ci)
        for i in range(3):
            img = np.kron(rng.randint(0, 255, (9, 9, 3)),
                          np.ones((8, 8, 1))).astype(np.uint8)
            cv2.imwrite(str(root / cls / f"img{i}.jpg"), img)
    seed = _both_paths_seed()
    state = cli.main(train_args(_argv(
        str(root), str(tmp_path / "o"), "--sp-method", "slic",
        "--seed", str(seed))))
    assert state.step == 2
    assert os.path.isfile(tmp_path / "o" / "checkpoint.pth")
    _check_consumed(recorded)
