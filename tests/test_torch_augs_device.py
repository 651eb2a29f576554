"""The port's batched device augmentations (``ops/augs_device.py``) against
the JAX package's (``videowalk_tpu/ops/augs_device.py``) on the CPU, op by
op, with JAX's draws injected into the port's apply functions; the whole
3-view transform's shapes and views; the crop sampler's distribution
against JAX's; and (``-m cuda``) the card against the CPU at the same
draws.

Tolerances: 1e-5 absolute on [0, 1] images (one f32 resampling or color
op each side, the same taps and weights, summed in another order; the
readings are ~2e-7). The sampler's moments over 4096 draws: means within
~5 standard errors of the difference of two such means, standard
deviations within 10%."""

import math

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.ops import augs_device as P

try:      # the card's machine has no JAX; its tests here are the -m cuda ones
    import jax
    import jax.numpy as jnp

    from videowalk_tpu.ops import augs_device as J
except ImportError:   # pragma: no cover - depends on the machine
    jax = jnp = J = None

torch.set_num_threads(1)

ATOL = 1e-5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _t(a):
    return torch.from_numpy(np.array(a))


def _imgs(B, h, w, seed=0):
    return np.random.RandomState(seed).rand(B, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("shape,out,scale,ratio", [
    ((8, 72, 72), 64, (0.8, 0.95), (0.7, 1.3)),     # the frame crop
    ((6, 40, 56), 32, (0.8, 0.95), (0.7, 1.3)),     # a non-square frame
    ((12, 16, 16), 16, (0.7, 0.9), (1.0, 1.0)),     # the patch jitter
    ((4, 20, 60), 24, (0.9, 0.95), (3.5, 4.0)),     # the centered fallback
])
def test_crop_resize_matches_jax_at_its_boxes(shape, out, scale, ratio):
    """``_sample_crop_boxes(key)``'s boxes into the port's ``crop_resize``
    against JAX's ``random_resized_crop(key)`` (``scale_and_translate``
    over the whole image, no antialiasing)."""
    imgs = _imgs(*shape)
    key = jax.random.PRNGKey(shape[0])
    box = J._sample_crop_boxes(key, shape[0], shape[1], shape[2], scale, ratio)
    crop = jax.jit(J.random_resized_crop, static_argnums=(2, 3, 4))
    ref = np.asarray(crop(key, jnp.asarray(imgs), out, scale, ratio))
    got = P.crop_resize(_t(imgs), *(_t(b) for b in box), out).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw,out", [((72, 72), 64), ((30, 50), 40)])
def test_resize_matches_jax_image_resize(hw, out):
    imgs = _imgs(3, *hw)
    ref = np.asarray(jax.image.resize(jnp.asarray(imgs), (3, out, out, 3),
                                      "linear"))
    np.testing.assert_allclose(P.resize(_t(imgs), out).numpy(), ref,
                               rtol=0, atol=ATOL)


def test_color_jitter_matches_jax_at_its_draws():
    """The factors and op orders of ``color_jitter(key)`` (the same key
    splits) into the port's apply; all six orders occur."""
    B = 36
    imgs = _imgs(B, 8, 8, seed=2)
    key = jax.random.PRNGKey(0)
    kb, kc, ks, ko = jax.random.split(key, 4)
    draws = [jax.random.uniform(k, (B,), minval=0.9, maxval=1.1)
             for k in (kb, kc, ks)]
    order = jax.random.randint(ko, (B,), 0, len(J._PERMS))
    assert set(np.asarray(order).tolist()) == set(range(6))
    ref = np.asarray(J.color_jitter(key, jnp.asarray(imgs)))
    got = P.color_jitter_apply(_t(imgs), *(_t(d) for d in draws),
                               _t(order)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert P.PERMS == tuple(J._PERMS)


def test_hflip_matches_jax_at_its_draws():
    imgs = _imgs(16, 6, 10, seed=3)
    key = jax.random.PRNGKey(5)
    flip = np.asarray(jax.random.uniform(key, (16,)) < 0.5)
    assert 0 < flip.sum() < 16
    ref = np.asarray(J.random_hflip(key, jnp.asarray(imgs)))
    np.testing.assert_array_equal(P.hflip_apply(_t(imgs), _t(flip)).numpy(),
                                  ref)


@pytest.mark.parametrize("S,patch", [(64, 16), (256, 64), (48, 32)])
def test_extract_patch_grid_matches_jax(S, patch):
    imgs = _imgs(2, S, S, seed=S)
    ref = np.asarray(J.extract_patch_grid(jnp.asarray(imgs), patch,
                                          patch // 2))
    got = P.extract_patch_grid(_t(imgs), patch, patch // 2).numpy()
    np.testing.assert_array_equal(got, ref)


def test_normalize_matches_jax():
    imgs = _imgs(2, 5, 5, seed=4)
    np.testing.assert_allclose(P.normalize(_t(imgs)).numpy(),
                               np.asarray(J.normalize(jnp.asarray(imgs))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("transforms,aug", [
    ("crop", "grid"), ("crop,cj,flip", "grid,cj,flip"), ("cj", "")])
def test_train_transform_device_views(transforms, aug):
    """Shapes and dtypes as JAX's; ``whole == normalize(whole_unnorm)``;
    [0, 1] unnormalized frames; the grid's patches are normalized jitter
    crops of the frames' windows; equal draws give equal views."""
    B, T, raw, S, p = 2, 3, 72, 64, 16
    clip = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (B, T, raw, raw, 3)).astype(np.uint8))
    views = [P.train_transform_device(clip, torch.Generator().manual_seed(3),
                                      S, p, aug, transforms) for _ in range(2)]
    ref = jax.eval_shape(lambda c: J.train_transform_device(
        jax.random.PRNGKey(0), c, img_size=S, patch_size=p, frame_aug=aug,
        frame_transforms=transforms), jnp.asarray(clip.numpy()))
    for k, v in views[0].items():
        assert tuple(v.shape) == ref[k].shape and v.dtype == torch.float32
        assert torch.equal(v, views[1][k])
    w, wu = views[0]["whole"], views[0]["whole_unnorm"]
    assert float(wu.min()) >= 0 and float(wu.max()) <= 1
    torch.testing.assert_close(w, P.normalize(wu), rtol=0, atol=0)
    if not aug:
        assert torch.equal(views[0]["grid"], w)


def test_train_transform_device_matches_jax_at_injected_draws():
    """The whole transform (crop + grid jitter, the config of record) at
    draws taken from JAX's ``train_transform_device`` key splits."""
    B, T, raw, S, p = 2, 2, 72, 64, 16
    clip = np.random.RandomState(2).randint(0, 256, (B, T, raw, raw, 3)
                                            ).astype(np.uint8)
    key = jax.random.PRNGKey(9)
    k_crop, _, _, k_grid = jax.random.split(key, 4)
    k_grid = jax.random.split(k_grid, 3)[0]
    n = (S - p) // (p // 2) + 1
    draws = {
        "crop": J._sample_crop_boxes(k_crop, B * T, raw, raw, (0.8, 0.95),
                                     (0.7, 1.3)),
        "grid_crop": J._sample_crop_boxes(k_grid, B * T * n * n, p, p,
                                          (0.7, 0.9), (1.0, 1.0))}
    draws = {k: tuple(_t(x) for x in v) for k, v in draws.items()}
    ref = J.train_transform_device(key, jnp.asarray(clip), img_size=S,
                                   patch_size=p, frame_aug="grid",
                                   frame_transforms="crop")
    got = P.apply_train_transform(torch.from_numpy(clip), draws, S, p, "grid")
    for k in ("whole_unnorm", "whole", "grid"):
        scale = 1.0 if k == "whole_unnorm" else 1 / min(P.IMG_STD)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=ATOL * scale)


def _moments(i, j, ch, cw, h, w):
    i, j, ch, cw = (np.asarray(x, np.float64) for x in (i, j, ch, cw))
    area = ch * cw / (h * w)
    logr = np.log(cw / ch)
    pos = i / np.maximum(h - ch, 1)
    return {"area": (area.mean(), area.std()), "log_ratio": (logr.mean(),
                                                             logr.std()),
            "row": (pos.mean(), pos.std())}


def test_crop_sampler_moments_match_jax():
    """4096 boxes from each sampler at the frame crop's law (288 px raw
    frames): mean and standard deviation of the area share, the log aspect
    ratio and the relative row position."""
    n, h, w = 4096, 288, 288
    ref = _moments(*J._sample_crop_boxes(jax.random.PRNGKey(1), n, h, w,
                                         (0.8, 0.95), (0.7, 1.3)), h, w)
    got = _moments(*P.draw_crop_boxes(torch.Generator().manual_seed(1), n,
                                      h, w), h, w)
    # standard error of a difference of two means of n draws
    se = {k: math.sqrt(2 / n) * v[1] for k, v in ref.items()}
    for k in ref:
        assert abs(got[k][0] - ref[k][0]) < 5 * se[k], (k, got[k], ref[k])
        assert abs(got[k][1] / ref[k][1] - 1) < 0.1, (k, got[k], ref[k])


@pytest.mark.cuda
@pytest.mark.parametrize("transforms,aug", [
    ("crop", "grid"), ("crop,cj,flip", "grid,cj,flip")])
def test_card_matches_cpu_at_the_same_draws(transforms, aug):
    """``apply_train_transform`` on the card against the CPU at draws made
    once on the CPU (the config of record's 288 px raw frames to 256, 7x7
    patches of 64), 1e-5 absolute on the [0, 1] views."""
    _need_card()
    B, T, raw, S, p = 2, 2, 288, 256, 64
    clip = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (B, T, raw, raw, 3)).astype(np.uint8))
    draws = P.draw_train_transform(torch.Generator().manual_seed(4), B, T,
                                   raw, raw, S, p, aug, transforms)
    cpu = P.apply_train_transform(clip, draws, S, p, aug)
    moved = {k: tuple(x.cuda() for x in v) if isinstance(v, tuple)
             else v.cuda() for k, v in draws.items()}
    card = P.apply_train_transform(clip.cuda(), moved, S, p, aug)
    for k, v in cpu.items():
        scale = 1.0 if k == "whole_unnorm" else 1 / min(P.IMG_STD)
        torch.testing.assert_close(card[k].cpu(), v, rtol=0,
                                   atol=ATOL * scale)


@pytest.mark.cuda
def test_card_draws_from_a_card_generator():
    _need_card()
    clip = torch.randint(0, 256, (2, 4, 288, 288, 3), dtype=torch.uint8,
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    views = P.train_transform_device(clip, gen)
    assert tuple(views["grid"].shape) == (2, 4, 49, 64, 64, 3)
    assert all(v.device.type == "cuda" and bool(torch.isfinite(v).all())
               for v in views.values())
