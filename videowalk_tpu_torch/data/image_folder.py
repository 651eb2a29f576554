"""Image-dataset training (counterpart of
``videowalk_tpu/data/image_folder.py``): the reference's ImageFolder branch,
made to train.

Reference: code/train.py:179-180 routes any image directory to
``torchvision.datasets.ImageFolder``, where each image is a 1-frame clip
and the palindrome walk over T=1 has no cycle to train on. Here, as in the
JAX package, each image becomes a ``clip_len``-frame static clip whose
frames are independently augmented views of it (the train transform draws
fresh crop/jitter/flip parameters per frame), so the walk across the views
is a cycle-consistency objective. Items follow ``Kinetics400``'s contract,
``(views, sp_mask, class_index)``, so both paths of the trainer run
unchanged.

``read_rgb`` is the cv2 file shell (cv2 imported at first use);
``ImageFolder.item`` the array core.
"""

from __future__ import annotations

import os

import numpy as np

from videowalk_tpu_torch.data.superpixels import host_sp_mask

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".tif",
                  ".tiff")
_VIDEO_EXTENSIONS = (".mp4", ".avi", ".mkv", ".webm", ".mov")


def is_image_folder(root: str) -> bool:
    """True when ``root`` looks like an image dataset: a directory whose
    class subdirectories hold image files (and no video files at the depth
    the Kinetics tree loader scans)."""
    if not os.path.isdir(root):
        return False
    for cls in sorted(os.listdir(root)):
        sub = os.path.join(root, cls)
        if not os.path.isdir(sub):
            continue
        for f in os.listdir(sub):
            ext = os.path.splitext(f)[1].lower()
            if ext in IMG_EXTENSIONS:
                return True
            if ext in _VIDEO_EXTENSIONS:
                return False
    return False


def read_rgb(path: str) -> np.ndarray:
    """An image file as ``(H, W, 3)`` uint8 RGB (``cv2.imread`` +
    BGR->RGB)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"could not read image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class ImageFolder:
    """``<root>/<class>/*.jpg`` image dataset yielding static video clips.

    Args:
      root: dataset root (one subdirectory per class, torchvision layout).
      clip_len: frames per synthetic clip (--clip-len).
      transform: the 3-view train transform (data/augs.py). Its per-frame
        random draws are what de-correlate the clip's frames.
      sp_method/...: superpixel options, as ``Kinetics400``'s (the mask is
        made from the augmented views like the reference worker,
        code/data/kinetics.py:119-126).
    """

    def __init__(self, root: str, clip_len: int = 4, transform=None,
                 sp_method: str = "none", num_components: int = 30,
                 prob: float = 1.0, randomise_superpixels: bool = False,
                 randomise_superpixels_range: int = 0,
                 sp_backend: str = "host", seed: int | None = None):
        self.root = root
        self.clip_len = clip_len
        self.transform = transform
        self.sp_method = sp_method
        self.num_components = num_components
        self.prob = prob
        self.randomise_superpixels = randomise_superpixels
        self.randomise_superpixels_range = randomise_superpixels_range
        self.sp_backend = sp_backend
        self.compactness = 200.0
        # per-item random streams in __getitem__ (thread-safe under the
        # concurrent loader; see data/kinetics.py)
        self.base_seed = (int(seed) if seed is not None
                          else int(np.random.SeedSequence().entropy
                                   % (2 ** 31)))

        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: list[tuple[str, int]] = []
        for c in self.classes:
            sub = os.path.join(root, c)
            for f in sorted(os.listdir(sub)):
                if os.path.splitext(f)[1].lower() in IMG_EXTENSIONS:
                    self.samples.append((os.path.join(sub, f),
                                         self.class_to_idx[c]))
        if not self.samples:
            raise FileNotFoundError(f"no images under {root!r}")

    def set_compactness(self, c: float) -> None:
        self.compactness = float(c)

    def __len__(self) -> int:
        return len(self.samples)

    def item(self, img: np.ndarray, idx: int):
        """``(views, sp_mask)`` of item ``idx`` from its ``(H, W, 3)`` uint8
        RGB image, with the item's stream ``RandomState([seed, idx])``."""
        clip = np.stack([img] * self.clip_len)          # (T, H, W, 3) uint8
        rng = np.random.RandomState([self.base_seed, int(idx)])
        views = (self.transform(clip, rng=rng)
                 if self.transform is not None else
                 {"grid": clip, "whole": clip, "whole_unnorm": clip})
        return views, host_sp_mask(views, self, rng)

    def __getitem__(self, idx: int):
        path, label = self.samples[idx]
        views, sp_mask = self.item(read_rgb(path), idx)
        return views, sp_mask, label
