"""Training augmentations on the host: the 3-view transform triple
(counterpart of ``videowalk_tpu/data/augs.py``; reference
``code/utils/augs.py``).

- ``IMG_MEAN`` / ``IMG_STD``: the reference's CIFAR-style stats (:10-11);
- the frame transform: RandomResizedCrop(scale .8-.95, ratio .7-1.3),
  ColorJitter(0.1), RandomHorizontalFlip, per frame (:110-136);
- ``patch_grid``: 64 px patches at stride 32 with a per-patch
  RandomResizedCrop(scale .7-.9) jitter (:59-82);
- ``TrainTransform``: the grid view, the whole normalized view and the
  whole unnormalized view, sharing one per-frame geometric and color draw
  (as the JAX package does, so that a mask segmented on the unnormalized
  view lines up with the features of the normalized one);
- ``RawClipTransform``: resize only, uint8, for the device augmentations
  (``ops/augs_device.py``).

numpy + cv2 (imported when a frame is transformed); every random number
comes from an explicit ``np.random.RandomState``, so the output equals the
JAX package's bit for bit at the same stream.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

IMG_MEAN = (0.4914, 0.4822, 0.4465)
IMG_STD = (0.2023, 0.1994, 0.2010)

# (img - mean) / std as img * (1/std) + (-mean/std): one multiply-add pass
_INV_STD = np.float32(1.0) / np.asarray(IMG_STD, np.float32)
_NEG_MEAN_OVER_STD = (-np.asarray(IMG_MEAN, np.float32)
                      * _INV_STD).astype(np.float32)


def normalize(img: np.ndarray) -> np.ndarray:
    """(img - mean) / std on float [0, 1] HWC."""
    out = img * _INV_STD
    out += _NEG_MEAN_OVER_STD
    return out


def _resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Bilinear resize to (h, w)."""
    import cv2

    return cv2.resize(img, (size[1], size[0]), interpolation=cv2.INTER_LINEAR)


def random_resized_crop_params(
    rng: np.random.RandomState, h: int, w: int,
    scale: tuple[float, float], ratio: tuple[float, float],
) -> tuple[int, int, int, int]:
    """torchvision ``RandomResizedCrop.get_params``: 10 area/log-ratio
    attempts, then a center crop at the closest valid ratio."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.randint(0, h - ch + 1)
            j = rng.randint(0, w - cw + 1)
            return i, j, ch, cw
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def random_resized_crop(rng, img, size: int, scale, ratio) -> np.ndarray:
    i, j, ch, cw = random_resized_crop_params(
        rng, img.shape[0], img.shape[1], scale, ratio)
    return _resize(img[i:i + ch, j:j + cw], (size, size))


def color_jitter(rng, img: np.ndarray, brightness=0.1, contrast=0.1,
                 saturation=0.1) -> np.ndarray:
    """torchvision ColorJitter on float [0, 1]: the enabled ops in a random
    order, factors uniform in [max(0, 1 - x), 1 + x]."""
    ops = []
    if brightness > 0:
        ops.append(("b", rng.uniform(max(0.0, 1 - brightness),
                                     1 + brightness)))
    if contrast > 0:
        ops.append(("c", rng.uniform(max(0.0, 1 - contrast), 1 + contrast)))
    if saturation > 0:
        ops.append(("s", rng.uniform(max(0.0, 1 - saturation),
                                     1 + saturation)))
    for k in rng.permutation(len(ops)):
        kind, f = ops[k]
        if kind == "b":
            img = img * f
        elif kind == "c":
            gray_mean = img.mean(axis=-1, keepdims=True).mean()
            img = gray_mean + f * (img - gray_mean)
        else:
            gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                    + 0.114 * img[..., 2])[..., None]
            img = gray + f * (img - gray)
        img = np.clip(img, 0.0, 1.0)
    return img.astype(np.float32)


def patch_grid(rng, frame: np.ndarray,
               patch_size: Sequence[int] = (64, 64, 3),
               stride_range: Sequence[float] = (0.5, 0.5),
               jitter_scale: tuple[float, float] = (0.7, 0.9)) -> np.ndarray:
    """Frame -> (N, ph, pw, 3) patch grid, each patch jittered by a
    RandomResizedCrop (the reference's stride range is degenerate)."""
    ph, pw = int(patch_size[0]), int(patch_size[1])
    s = (rng.random_sample() * (stride_range[1] - stride_range[0])
         + stride_range[0])
    sh, sw = max(1, int(ph * s)), max(1, int(pw * s))
    H, W = frame.shape[:2]
    patches = []
    for i in range(0, H - ph + 1, sh):
        for j in range(0, W - pw + 1, sw):
            patches.append(random_resized_crop(
                rng, frame[i:i + ph, j:j + pw], ph, jitter_scale, (1.0, 1.0)))
    return np.stack(patches)


class TrainTransform:
    """``transform(vid, rng) -> dict`` with vid ``(T, H, W, 3)`` uint8 RGB:

      grid:          (T, N, ph, pw, 3) normalized patch grid  [frame_aug grid]
                     or (T, S, S, 3) normalized               [otherwise]
      whole:         (T, S, S, 3) normalized full frames
      whole_unnorm:  (T, S, S, 3) float [0, 1] full frames
    """

    def __init__(self, img_size=256, frame_transforms="crop", frame_aug="grid",
                 patch_size=(64, 64, 3), rng=None):
        self.img_size = img_size
        self.frame_transforms = frame_transforms
        self.frame_aug = frame_aug
        self.patch_size = patch_size
        self.rng = rng or np.random.RandomState()

    def _frame(self, img: np.ndarray, rng) -> np.ndarray:
        """Per-frame base transform: crop / cj / flip -> float [0, 1] SxS."""
        img = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img
        fts = self.frame_transforms
        if "crop" in fts:
            img = random_resized_crop(rng, img, self.img_size,
                                      (0.8, 0.95), (0.7, 1.3))
        else:
            img = _resize(img, (self.img_size, self.img_size))
        if "cj" in fts:
            img = color_jitter(rng, img)
        if "flip" in fts and rng.random_sample() < 0.5:
            img = img[:, ::-1]
        return np.ascontiguousarray(img, np.float32)

    def __call__(self, vid: np.ndarray, rng=None) -> dict[str, np.ndarray]:
        # datasets pass one stream per item (RandomState is not thread-safe)
        rng = self.rng if rng is None else rng
        frames = [self._frame(v, rng) for v in vid]
        whole_unnorm = np.stack(frames)
        whole = normalize(whole_unnorm)
        if "grid" in self.frame_aug:
            grids = []
            for f in frames:
                g = patch_grid(rng, f, self.patch_size)
                if "cj" in self.frame_aug:
                    g = np.stack([color_jitter(rng, p) for p in g])
                if "flip" in self.frame_aug:
                    g = np.stack([p[:, ::-1] if rng.random_sample() < 0.5
                                  else p for p in g])
                grids.append(normalize(g))
            grid = np.stack(grids)
        else:
            grid = whole
        return {"grid": grid.astype(np.float32, copy=False),
                "whole": whole.astype(np.float32, copy=False),
                "whole_unnorm": whole_unnorm}


class RawClipTransform:
    """Host transform of the device-augmentation pipeline (``--augs-backend
    device``): each frame resized to one square of ``img_size * 1.125`` px
    (room for the device's RandomResizedCrop), kept uint8."""

    def __init__(self, img_size: int = 256, decode_margin: float = 1.125):
        self.size = int(img_size * decode_margin)

    def __call__(self, vid: np.ndarray, rng=None) -> dict[str, np.ndarray]:
        del rng  # deterministic; taken for the shared transform contract
        import cv2

        return {"raw": np.stack([
            cv2.resize(v, (self.size, self.size),
                       interpolation=cv2.INTER_LINEAR) for v in vid])}


def get_train_transforms(args) -> TrainTransform:
    """The training transform from the reference's flag surface."""
    return TrainTransform(
        img_size=getattr(args, "img_size", 256),
        frame_transforms=getattr(args, "frame_transforms", "crop"),
        frame_aug=getattr(args, "frame_aug", "grid"),
        patch_size=tuple(getattr(args, "patch_size", (64, 64, 3))),
        rng=np.random.RandomState(getattr(args, "seed", None)),
    )
