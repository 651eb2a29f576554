"""Kinetics-style clip dataset over ``<root>/<class>/*.mp4`` (counterpart of
``videowalk_tpu/data/kinetics.py``; reference ``code/data/kinetics.py``).

Directory scan + clip index, per-item decode -> transform, the decode
retry with a fresh random index (reference :102-112), the
``set_compactness`` knob (:96-100) and per-(seed, epoch, item) random
streams. Superpixels run on the device (``--sp-backend device``: the
trainer segments the unnormalized view with ``ops/slic.py``); the
host segmentation of the JAX package (``sp_backend="host"``) is not ported
yet and raises.
"""

from __future__ import annotations

import os

import numpy as np

from videowalk_tpu_torch.data.clips import VideoClipIndex

VIDEO_EXTENSIONS = (".mp4", ".avi", ".webm", ".mov", ".mkv")


def find_videos(root: str, extensions=VIDEO_EXTENSIONS):
    """``<root>/<class>/*.ext`` -> (paths, labels, classes), sorted like
    torchvision's ``make_dataset``."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(tuple(extensions)):
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
    return paths, labels, classes


class Kinetics400:
    """``dataset[i] -> (views, sp_mask, label)``: ``views`` is the
    transform's dict (``grid``/``whole``/``whole_unnorm``, or ``raw`` for
    the device augmentations), ``sp_mask`` an empty int32 array (the masks
    are made on the device) and ``label`` the class index."""

    def __init__(
        self,
        root: str,
        frames_per_clip: int,
        step_between_clips: int = 1,
        frame_rate: float | None = None,
        extensions=VIDEO_EXTENSIONS,
        transform=None,
        _precomputed_metadata: dict | None = None,
        sp_method: str = "slic",
        num_components: int = 30,
        prob: float = 1.0,
        randomise_superpixels: bool = False,
        randomise_superpixels_range: int = 10,
        sp_backend: str = "device",
        seed: int | None = None,
    ):
        if sp_method != "none" and sp_backend == "host":
            raise NotImplementedError(
                "sp_backend='host' (host SLIC/Felzenszwalb in the loader) is "
                "not ported to videowalk_tpu_torch yet (see ROADMAP.md); use "
                "sp_backend='device'")
        exts = tuple(e if e.startswith(".") else "." + e for e in extensions)
        self.root = root
        self.video_list, self.labels, self.classes = find_videos(root, exts)
        self.samples = list(zip(self.video_list, self.labels))
        self.video_clips = VideoClipIndex(
            self.video_list, frames_per_clip, step_between_clips, frame_rate,
            _metadata=_precomputed_metadata)
        self.transform = transform
        self.sp_method = sp_method
        self.num_components = num_components
        self.prob = prob
        self.randomise_superpixels = randomise_superpixels
        self.randomise_superpixels_range = randomise_superpixels_range
        self.sp_backend = sp_backend
        self.compactness = 100
        # per-item random streams (see __getitem__): the threaded loader
        # calls __getitem__ concurrently, and one shared RandomState is not
        # thread-safe. Without a seed a fresh base is drawn.
        self.base_seed = (int(seed) if seed is not None
                          else int(np.random.SeedSequence().entropy
                                   % (2 ** 31)))
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-item random streams, so that a clip revisited in
        a later epoch gets fresh decode-retry and augmentation draws."""
        self._epoch = int(epoch)

    def __len__(self):
        return self.video_clips.num_clips()

    def set_compactness(self, compactness):
        self.compactness = compactness

    def get_compactness(self):
        return self.compactness

    def __getitem__(self, idx: int):
        # one stream per (seed, epoch, item): thread-safe and independent
        # of the number of loader workers
        rng = np.random.RandomState([self.base_seed, self._epoch, int(idx)])
        if len(self) == 0:
            raise RuntimeError(
                f"dataset at {self.root} contains no clips (no video files "
                f"matched, or every video is shorter than frames_per_clip)")
        for _ in range(100):
            try:
                video, _info, video_idx = self.video_clips.get_clip(idx)
                break
            except Exception as e:  # noqa: BLE001 - any decode failure
                print("skipped idx", idx, "Error:", e, flush=True)
                idx = int(rng.randint(len(self)))
        else:
            raise RuntimeError("could not decode any clip after 100 retries")

        label = self.labels[video_idx]
        views = (self.transform(video, rng=rng)
                 if self.transform is not None else
                 {"grid": video, "whole": video, "whole_unnorm": video})
        return views, np.zeros((0,), np.int32), label


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".tif",
                  ".tiff")


def is_image_folder(root: str) -> bool:
    """True when ``root`` holds class subdirectories of image files (and no
    video files at the depth this loader scans): the trainer's
    routing to the image-folder dataset, which is not ported yet."""
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
            if ext in VIDEO_EXTENSIONS:
                return False
    return False
