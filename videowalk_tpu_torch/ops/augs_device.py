"""Batched augmentation on the clip's device (counterpart of
``videowalk_tpu/ops/augs_device.py``): the 3-view transform triple of
``data/augs.py`` over all ``(B, T)`` frames at once, for ``--augs-backend
device``, where the loader ships raw uint8 frames.

- ``random_resized_crop``: per-image crop boxes from torchvision's
  scale/log-ratio distribution (10 candidates, the first that fits, else a
  centered crop), resampled by the JAX package's operator,
  ``jax.image.scale_and_translate(..., method="linear", antialias=False)``
  over the whole image: one triangle-kernel weight matrix per axis and
  image, taps outside the image dropped and the rest renormalized;
- ``color_jitter``: brightness, contrast and saturation factors per image,
  applied in a per-image order (one of the 6 permutations);
- ``random_hflip``; ``normalize`` (CIFAR-style stats);
- ``extract_patch_grid``: the 7x7 grid of 64 px windows at stride 32, and
  the per-patch jitter crop.

Each op is split into a draw, which takes its random numbers from an
explicit ``torch.Generator``, and an apply, which takes the draws as
arguments, so the JAX package's draws can be fed to the apply. The random
streams differ from JAX's; the distributions are the same. This op has no
Pallas counterpart: it is plain PyTorch on the card.
"""

from __future__ import annotations

import math

import torch

from videowalk_tpu_torch.core import rng
from videowalk_tpu_torch.data.augs import IMG_MEAN, IMG_STD
from videowalk_tpu_torch.utils.device import full_f32_matmul

PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
_EPS = float(torch.finfo(torch.float32).eps)


def _const(values, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """``values`` as a tensor on ``device``, copied without waiting for the
    card's queue (``torch.tensor(..., device=)`` would)."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def normalize(img: torch.Tensor) -> torch.Tensor:
    return ((img - _const(IMG_MEAN, img.device, img.dtype))
            / _const(IMG_STD, img.device, img.dtype))


def _rand(generator: torch.Generator, *shape) -> torch.Tensor:
    # a GlobalBatchGenerator keeps its rank's rows of the global draw
    return rng.rand(shape, generator)


# ------------------------------------------------------------------- crops


def draw_crop_boxes(generator: torch.Generator, B: int, h: int, w: int,
                    scale=(0.8, 0.95), ratio=(0.7, 1.3)):
    """``B`` crop boxes ``(i, j, ch, cw)`` (int32, on the generator's
    device): 10 candidates each from the area / log-ratio distribution,
    the first that fits, else the ratio-clamped centered crop."""
    u_area, u_ratio = _rand(generator, B, 10), _rand(generator, B, 10)
    u_i, u_j = _rand(generator, B), _rand(generator, B)
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    target_area = (h * w) * (scale[0] + u_area * (scale[1] - scale[0]))
    aspect = torch.exp(lo + u_ratio * (hi - lo))
    cw = torch.round(torch.sqrt(target_area * aspect)).to(torch.int32)
    ch = torch.round(torch.sqrt(target_area / aspect)).to(torch.int32)
    ok = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    in_ratio = w / h
    if in_ratio < min(ratio):
        fb_w, fb_h = w, int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        fb_w, fb_h = int(round(h * max(ratio))), h
    else:
        fb_w, fb_h = w, h
    first = ok.to(torch.uint8).argmax(1, keepdim=True)   # the first True
    any_ok = ok.any(1)
    cw = torch.where(any_ok, cw.gather(1, first)[:, 0], fb_w)
    ch = torch.where(any_ok, ch.gather(1, first)[:, 0], fb_h)
    i = (u_i * (h - ch + 1)).to(torch.int32)
    j = (u_j * (w - cw + 1)).to(torch.int32)
    i = torch.where(any_ok, i, (h - ch) // 2)
    j = torch.where(any_ok, j, (w - cw) // 2)
    return i, j, ch, cw


def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor, antialias: bool = False
                     ) -> torch.Tensor:
    """``(B, out_size, in_size)`` weights of a linear (triangle) resampler
    of one axis, per image (``scale``, ``translation``: ``(B,)`` f32), as
    ``jax.image.scale_and_translate`` builds them: output sample ``o``
    reads input position ``(o + 0.5 - translation) / scale - 0.5``; taps
    outside ``[0, in_size)`` are dropped and the rest renormalized;
    samples outside ``[-0.5, in_size - 0.5]`` are zero."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = (torch.clamp(inv_scale, min=1.0)[..., None] if antialias
                    else 1.0)
    o = torch.arange(out_size, dtype=torch.float32, device=dev)[None]
    sample = (o + 0.5) * inv_scale - translation[:, None] * inv_scale - 0.5
    x = (sample[..., None] - torch.arange(in_size, dtype=torch.float32,
                                          device=dev)).abs() / kernel_scale
    wts = torch.clamp(1.0 - x, min=0.0)
    total = wts.sum(-1, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * _EPS,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None], wts, 0.0)


def resample(imgs: torch.Tensor, wr: torch.Tensor, wc: torch.Tensor
             ) -> torch.Tensor:
    """``imgs (B, h, w, c)`` through row weights ``wr (B, H, h)`` and
    column weights ``wc (B, W, w)`` -> ``(B, H, W, c)``, in full f32."""
    with full_f32_matmul():
        rows = torch.einsum("boh,bhwc->bowc", wr, imgs)
        return torch.einsum("bpw,bowc->bopc", wc, rows)


def crop_resize(imgs: torch.Tensor, i, j, ch, cw, out_size: int
                ) -> torch.Tensor:
    """Bilinear crop-and-resize of ``imgs (B, h, w, 3)`` at the boxes
    ``(i, j, ch, cw)`` to ``(B, out, out, 3)``: the JAX package's
    ``_crop_resize_one`` (scale ``out / ch``, translation ``-i * scale``,
    no antialiasing), batched."""
    h, w = imgs.shape[1], imgs.shape[2]
    sy = out_size / ch.to(torch.float32)
    sx = out_size / cw.to(torch.float32)
    wr = resample_weights(h, out_size, sy, -(i.to(torch.float32) * sy))
    wc = resample_weights(w, out_size, sx, -(j.to(torch.float32) * sx))
    return resample(imgs, wr, wc)


def resize(imgs: torch.Tensor, out_size: int) -> torch.Tensor:
    """``jax.image.resize(imgs, (B, out, out, c), "linear")``: the whole
    image, antialiased where it shrinks."""
    B, h, w = imgs.shape[:3]
    ones = torch.ones(B, dtype=torch.float32, device=imgs.device)
    zero = torch.zeros_like(ones)
    wr = resample_weights(h, out_size, ones * (out_size / h), zero, True)
    wc = resample_weights(w, out_size, ones * (out_size / w), zero, True)
    return resample(imgs, wr, wc)


def random_resized_crop(imgs: torch.Tensor, generator: torch.Generator,
                        out_size: int, scale=(0.8, 0.95), ratio=(0.7, 1.3)
                        ) -> torch.Tensor:
    """Per-image RandomResizedCrop: ``(B, h, w, 3) -> (B, s, s, 3)``."""
    box = draw_crop_boxes(generator, imgs.shape[0], imgs.shape[1],
                          imgs.shape[2], scale, ratio)
    return crop_resize(imgs, *box, out_size)


# ------------------------------------------------------------------- color


def draw_color_jitter(generator: torch.Generator, B: int, brightness=0.1,
                      contrast=0.1, saturation=0.1):
    """``(fb, fc, fs, order)``: factors uniform in ``[max(0, 1 - x),
    1 + x]`` and the index of each image's op order in ``PERMS``."""
    def factor(x):
        lo, hi = max(0.0, 1 - x), 1 + x
        return lo + _rand(generator, B) * (hi - lo)

    fb, fc, fs = factor(brightness), factor(contrast), factor(saturation)
    order = rng.randint(0, len(PERMS), (B,), generator)
    return fb, fc, fs, order


def color_jitter_apply(imgs: torch.Tensor, fb, fc, fs, order) -> torch.Tensor:
    """ColorJitter of ``imgs (B, h, w, 3)`` in [0, 1] at the drawn factors,
    each image in its own op order (0 brightness, 1 contrast, 2
    saturation), each op clipped to [0, 1]."""
    ops = _const(PERMS, imgs.device, torch.int64)[order.long()]   # (B, 3)
    per = (imgs.shape[0], 1, 1, 1)
    fb, fc, fs = (f.to(imgs.dtype).reshape(per) for f in (fb, fc, fs))
    x = imgs
    for pos in range(3):
        op = ops[:, pos].reshape(per)
        bright = (x * fb).clamp(0, 1)
        m = x.mean(-1).mean((1, 2)).reshape(per)
        contr = (m + fc * (x - m)).clamp(0, 1)
        g = (0.299 * x[..., 0] + 0.587 * x[..., 1]
             + 0.114 * x[..., 2])[..., None]
        satur = (g + fs * (x - g)).clamp(0, 1)
        x = torch.where(op == 0, bright, torch.where(op == 1, contr, satur))
    return x


def color_jitter(imgs: torch.Tensor, generator: torch.Generator,
                 brightness=0.1, contrast=0.1, saturation=0.1) -> torch.Tensor:
    return color_jitter_apply(imgs, *draw_color_jitter(
        generator, imgs.shape[0], brightness, contrast, saturation))


# -------------------------------------------------------------------- flips


def draw_hflip(generator: torch.Generator, B: int, p: float = 0.5):
    return _rand(generator, B) < p


def hflip_apply(imgs: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip.reshape(-1, 1, 1, 1), imgs.flip(2), imgs)


def random_hflip(imgs: torch.Tensor, generator: torch.Generator,
                 p: float = 0.5) -> torch.Tensor:
    return hflip_apply(imgs, draw_hflip(generator, imgs.shape[0], p))


# ----------------------------------------------------------------- the grid


def extract_patch_grid(frames: torch.Tensor, patch: int, stride: int
                       ) -> torch.Tensor:
    """``(B, S, S, 3) -> (B, N, patch, patch, 3)`` overlapping windows,
    row-major."""
    B = frames.shape[0]
    tiles = frames.unfold(1, patch, stride).unfold(2, patch, stride)
    n_i, n_j = tiles.shape[1], tiles.shape[2]       # (B, n, n, 3, p, p)
    return tiles.permute(0, 1, 2, 4, 5, 3).reshape(B, n_i * n_j, patch,
                                                   patch, frames.shape[-1])


# ------------------------------------------------------------ the 3 views


def draw_train_transform(generator: torch.Generator, B: int, T: int, h: int,
                         w: int, img_size: int = 256, patch_size: int = 64,
                         frame_aug: str = "grid",
                         frame_transforms: str = "crop") -> dict:
    """Every random number of one ``train_transform_device`` call, drawn
    from ``generator``: per-frame crop boxes, color factors and flips, then
    the grid's per-patch jitter boxes, color factors and flips."""
    n = B * T
    d = {}
    if "crop" in frame_transforms:
        d["crop"] = draw_crop_boxes(generator, n, h, w)
    if "cj" in frame_transforms:
        d["cj"] = draw_color_jitter(generator, n)
    if "flip" in frame_transforms:
        d["flip"] = draw_hflip(generator, n)
    if "grid" in frame_aug:
        side = (img_size - patch_size) // (patch_size // 2) + 1
        m = n * side * side
        d["grid_crop"] = draw_crop_boxes(generator, m, patch_size, patch_size,
                                         scale=(0.7, 0.9), ratio=(1.0, 1.0))
        if "cj" in frame_aug:
            d["grid_cj"] = draw_color_jitter(generator, m)
        if "flip" in frame_aug:
            d["grid_flip"] = draw_hflip(generator, m)
    return d


def apply_train_transform(clip: torch.Tensor, draws: dict,
                          img_size: int = 256, patch_size: int = 64,
                          frame_aug: str = "grid") -> dict:
    """The 3-view triple of ``clip (B, T, H, W, 3)`` (uint8, or floats in
    [0, 1]) at ``draws`` (``draw_train_transform``'s, or injected):
    ``grid`` ``(B, T, N, p, p, 3)`` normalized patches (``whole`` without
    ``grid`` in ``frame_aug``), ``whole`` ``(B, T, S, S, 3)`` normalized and
    ``whole_unnorm`` in [0, 1]."""
    B, T = clip.shape[:2]
    x = clip.reshape(B * T, *clip.shape[2:]).to(torch.float32)
    if clip.dtype == torch.uint8:
        x = x / 255.0
    x = (crop_resize(x, *draws["crop"], img_size) if "crop" in draws
         else resize(x, img_size))
    if "cj" in draws:
        x = color_jitter_apply(x, *draws["cj"])
    if "flip" in draws:
        x = hflip_apply(x, draws["flip"])
    whole_unnorm = x.reshape(B, T, img_size, img_size, 3)
    whole = normalize(whole_unnorm)
    if "grid" not in frame_aug:
        return {"grid": whole, "whole": whole, "whole_unnorm": whole_unnorm}
    patches = extract_patch_grid(x, patch_size, patch_size // 2)
    N = patches.shape[1]
    flat = crop_resize(patches.reshape(B * T * N, patch_size, patch_size, 3),
                       *draws["grid_crop"], patch_size)
    if "grid_cj" in draws:
        flat = color_jitter_apply(flat, *draws["grid_cj"])
    if "grid_flip" in draws:
        flat = hflip_apply(flat, draws["grid_flip"])
    grid = normalize(flat.reshape(B, T, N, patch_size, patch_size, 3))
    return {"grid": grid, "whole": whole, "whole_unnorm": whole_unnorm}


def train_transform_device(clip: torch.Tensor, generator: torch.Generator,
                           img_size: int = 256, patch_size: int = 64,
                           frame_aug: str = "grid",
                           frame_transforms: str = "crop") -> dict:
    """The full 3-view transform triple of ``clip (B, T, H, W, 3)`` on its
    device, random numbers from ``generator`` (on the same device)."""
    B, T, H, W = clip.shape[:4]
    draws = draw_train_transform(generator, B, T, H, W, img_size, patch_size,
                                 frame_aug, frame_transforms)
    return apply_train_transform(clip, draws, img_size, patch_size, frame_aug)
