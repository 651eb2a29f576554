"""Frame-folder datasets (counterpart of ``videowalk_tpu/data/video.py``;
reference ``code/data/video.py``).

- ``VideoList``: a filelist of ``<jpeg_dir> <frame_count>`` lines; random
  clip start, the frame gap shrunk when the video is too short (reference
  :51-56), BGR -> RGB reads (:75). cv2 is imported when a frame is read.
- ``SingleVideoDataset``: random clips from one in-memory video (:90-104).
"""

from __future__ import annotations

import os

import numpy as np


def _fresh_seed(seed: int | None) -> int:
    return (int(seed) if seed is not None
            else int(np.random.SeedSequence().entropy % (2 ** 31)))


class VideoList:
    def __init__(self, filelist: str, clip_len: int, is_train: bool = True,
                 frame_gap: int = 1, transform=None, random_clip: bool = True,
                 seed: int | None = None):
        self.filelist = filelist
        self.clip_len = clip_len
        self.is_train = is_train
        self.frame_gap = frame_gap
        self.random_clip = random_clip
        self.transform = transform
        self.base_seed = _fresh_seed(seed)   # per-item streams, as Kinetics400
        self._epoch = 0
        self._files_cache: dict[str, list[str]] = {}

        self.jpgfiles, self.fnums = [], []
        with open(filelist) as f:
            for line in f:
                rows = line.split()
                if not rows:
                    continue
                self.jpgfiles.append(rows[0])
                self.fnums.append(int(rows[1]))

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-item random streams: this dataset iterates in a
        fixed order, so without the epoch every epoch would replay the same
        clips and augmentations."""
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.jpgfiles)

    def _frame_files(self, folder_path: str) -> list[str]:
        """Numeric frame names in numeric order, cached per folder."""
        files = self._files_cache.get(folder_path)
        if files is None:
            files = sorted(
                (f for f in os.listdir(folder_path)
                 if f.split(".")[0].isdigit()),
                key=lambda x: int(x.split(".")[0]))
            self._files_cache[folder_path] = files
        return files

    def __getitem__(self, index: int):
        import cv2

        index = index % len(self.jpgfiles)
        folder_path = self.jpgfiles[index]
        fnum = self.fnums[index]

        frame_gap = self.frame_gap
        while fnum - self.clip_len * frame_gap < 0 and frame_gap > 1:
            frame_gap -= 1
        if fnum < self.clip_len:
            raise ValueError(
                f"video {folder_path} has {fnum} frames < clip_len "
                f"{self.clip_len}; remove it from {self.filelist} or lower "
                f"--clip-len")
        rng = np.random.RandomState([self.base_seed, self._epoch,
                                     int(index)])
        diffnum = fnum - self.clip_len * frame_gap
        startframe = int(rng.randint(0, max(1, diffnum + 1))) \
            if self.random_clip else 0

        files = self._frame_files(folder_path)
        if len(files) < fnum:
            raise ValueError(
                f"filelist claims {fnum} frames for {folder_path} but only "
                f"{len(files)} numeric frame files exist on disk")
        imgs = []
        for i in range(self.clip_len):
            fpath = os.path.join(folder_path,
                                 files[int(startframe + i * frame_gap)])
            img = cv2.imread(fpath)
            if img is None:
                raise IOError(f"could not decode frame {fpath}")
            imgs.append(img[:, :, ::-1])  # BGR -> RGB
        imgs = np.stack(imgs)

        if self.transform is not None:
            imgs = self.transform(imgs, rng=rng)
        return imgs, 0, 0


class SingleVideoDataset:
    """Random fixed-length clips from one in-memory video."""

    def __init__(self, video: np.ndarray, clip_len: int,
                 fps_range=(1, 1), n_clips: int = 100000,
                 seed: int | None = None):
        self.video = video
        self.clip_len = clip_len
        self.fps = fps_range
        self.n_clips = n_clips
        self.base_seed = _fresh_seed(seed)
        self._epoch = 0
        if video.shape[0] // max(1, fps_range[1]) < clip_len:
            raise ValueError(
                f"video of {video.shape[0]} frames cannot yield "
                f"{clip_len}-frame clips at fps divisor up to "
                f"{fps_range[1]}")

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self):
        return self.n_clips

    def __getitem__(self, index: int):
        rng = np.random.RandomState([self.base_seed, self._epoch,
                                     int(index)])
        lo, hi = self.fps
        fps = int(rng.randint(lo, max(lo + 1, hi)))
        max_start = self.video.shape[0] // fps - self.clip_len
        idx = int(rng.randint(0, max(1, max_start + 1)))
        return self.video[::fps][idx:idx + self.clip_len]
