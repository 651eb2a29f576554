"""Video clip indexing and sampling (counterpart of
``videowalk_tpu/data/clips.py``; reference: torchvision's ``VideoClips``
and ``RandomClipSampler``, ``code/train.py:191-218``).

- per-video frame-accurate clip windows of ``frames_per_clip`` frames,
  ``step_between_clips`` apart, after optional fps resampling
  (torchvision's ``_resample_video_idx`` floor-arange rule);
- metadata (frame counts and fps) computed once and cacheable as a pickle
  that the JAX package reads and writes too;
- ``RandomClipSampler``: at most ``max_clips_per_video`` random clips per
  video, shuffled across videos; ``UniformClipSampler``: evenly spaced.

Decode goes through OpenCV's ffmpeg backend; cv2 is imported when a video
is probed or decoded, never when this module is imported.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import random
from typing import Sequence

import numpy as np


def _cv2():
    try:
        import cv2
    except Exception as e:  # pragma: no cover - depends on the machine
        raise RuntimeError("opencv-python (cv2) is needed to probe and "
                           "decode videos and failed to import") from e
    return cv2


def _probe(path: str) -> tuple[int, float]:
    """(frame_count, fps) of a video file."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
        return n, fps
    finally:
        cap.release()


def resample_idx(num_frames: int, original_fps: float, new_fps: float | None
                 ) -> np.ndarray:
    """torchvision ``VideoClips._resample_video_idx`` rule."""
    if new_fps is None or original_fps <= 0:
        return np.arange(num_frames)
    step = original_fps / new_fps
    if step.is_integer():
        return np.arange(0, num_frames, int(step))
    total = int(num_frames / step)
    return (np.arange(total) * step).astype(np.int64)


@dataclasses.dataclass
class VideoClipIndex:
    """Frame-accurate clip index over a list of video files."""

    video_paths: list
    frames_per_clip: int
    step_between_clips: int = 1
    frame_rate: float | None = None
    _metadata: dict | None = None

    def __post_init__(self):
        if self._metadata is not None:
            # cached counts pair with videos by position: a cache from a
            # tree that gained, lost or reordered files would give clip
            # windows from another video's frame count
            cached_paths = self._metadata.get("video_paths")
            if (cached_paths is not None
                    and list(cached_paths) != list(self.video_paths)):
                raise ValueError(
                    "cached dataset metadata does not match the current "
                    "video tree (files added/removed/reordered since the "
                    "cache was written): delete the cache file or point "
                    "--cache-path elsewhere")
            self.video_frames = list(self._metadata["video_frames"])
            self.video_fps = list(self._metadata["video_fps"])
        else:
            if self.video_paths:
                _cv2()   # a missing cv2 is one error, not a probe per video
            self.video_frames, self.video_fps = [], []
            failed = []
            for p in self.video_paths:
                try:
                    n, fps = _probe(p)
                except Exception as e:  # noqa: BLE001 - any probe failure
                    # skip the video (the reference tolerates corrupt
                    # videos) but say so
                    failed.append((p, e))
                    n, fps = 0, 30.0
                self.video_frames.append(n)
                self.video_fps.append(fps)
            if failed:
                shown = "; ".join(f"{p} ({e})" for p, e in failed[:5])
                print(f"WARNING: {len(failed)} of {len(self.video_paths)} "
                      f"videos failed to probe and are excluded from the "
                      f"clip index: {shown}"
                      + ("; ..." if len(failed) > 5 else ""), flush=True)
                if len(failed) == len(self.video_paths):
                    raise RuntimeError(
                        "every video failed to probe: check codecs and "
                        f"permissions (first error: {failed[0][0]}: "
                        f"{failed[0][1]})")
        self.compute_clips(self.frames_per_clip, self.step_between_clips,
                           self.frame_rate)

    def metadata(self) -> dict:
        return {"video_paths": list(self.video_paths),
                "video_frames": list(self.video_frames),
                "video_fps": list(self.video_fps)}

    def save_metadata(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.metadata(), f)

    @staticmethod
    def load_metadata(path: str) -> dict:
        with open(path, "rb") as f:
            return pickle.load(f)

    def compute_clips(self, frames_per_clip: int, step: int,
                      frame_rate: float | None = None) -> None:
        """(Re)build the clip table."""
        self.frames_per_clip = frames_per_clip
        self.step_between_clips = step
        self.frame_rate = frame_rate
        self.clips: list[np.ndarray] = []   # per video: (n_clips, T) frame ids
        self.cumulative = [0]
        for vi, n in enumerate(self.video_frames):
            idxs = resample_idx(n, self.video_fps[vi], frame_rate)
            n_clips = max(0, (len(idxs) - frames_per_clip) // step + 1)
            windows = (np.arange(frames_per_clip)[None, :]
                       + step * np.arange(n_clips)[:, None])
            self.clips.append(idxs[windows] if n_clips > 0
                              else np.zeros((0, frames_per_clip), np.int64))
            self.cumulative.append(self.cumulative[-1] + n_clips)

    def num_clips(self) -> int:
        return self.cumulative[-1]

    def get_clip_location(self, idx: int) -> tuple[int, int]:
        vi = int(np.searchsorted(self.cumulative, idx, side="right")) - 1
        return vi, idx - self.cumulative[vi]

    def get_clip(self, idx: int) -> tuple[np.ndarray, dict, int]:
        """Decode clip ``idx`` -> (frames (T, H, W, 3) uint8 RGB, info,
        video index)."""
        if not 0 <= idx < self.num_clips():
            raise IndexError(idx)
        vi, ci = self.get_clip_location(idx)
        frames = decode_frames(self.video_paths[vi], self.clips[vi][ci])
        return frames, {"video_fps": self.video_fps[vi]}, vi


def decode_frames(path: str, frame_idxs: Sequence[int]) -> np.ndarray:
    """Decode the frames ``frame_idxs`` of a video file (RGB uint8).

    Seeks to the earliest one, then reads on. ffmpeg's seek is
    frame-accurate on constant-frame-rate mp4; ``VIDEOWALK_SEQ_DECODE=1``
    skims from frame 0 instead (exact on any container)."""
    cv2 = _cv2()
    frame_idxs = np.asarray(frame_idxs)
    first, last = int(frame_idxs.min()), int(frame_idxs.max())
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        if first > 0:
            if os.environ.get("VIDEOWALK_SEQ_DECODE", "") not in ("", "0"):
                for _ in range(first):
                    cap.grab()
            else:
                cap.set(cv2.CAP_PROP_POS_FRAMES, first)
        needed = set(int(i) for i in frame_idxs)
        buf = {}
        for fi in range(first, last + 1):
            ok, frame = cap.read()
            if not ok:
                raise IOError(f"decode failed at frame {fi} of {path}")
            if fi in needed:
                buf[fi] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        return np.stack([buf[int(i)] for i in frame_idxs])
    finally:
        cap.release()


class UniformClipSampler:
    """Evenly spaced ``num_clips_per_video`` clips per video, in order
    (torchvision semantics: the linspace is floored)."""

    def __init__(self, clip_index: VideoClipIndex, num_clips_per_video: int):
        self.clip_index = clip_index
        self.num_clips_per_video = num_clips_per_video

    def __iter__(self):
        idxs = []
        cum = self.clip_index.cumulative
        for vi in range(len(cum) - 1):
            if cum[vi + 1] - cum[vi] <= 0:
                continue
            pos = np.linspace(cum[vi], cum[vi + 1] - 1,
                              num=self.num_clips_per_video)
            idxs.extend(int(p) for p in np.floor(pos))
        return iter(idxs)

    def __len__(self):
        cum = self.clip_index.cumulative
        nonempty = sum(1 for vi in range(len(cum) - 1)
                       if cum[vi + 1] - cum[vi] > 0)
        return nonempty * self.num_clips_per_video


class RandomClipSampler:
    """At most ``max_clips_per_video`` random clips per video, shuffled.
    Each pass (``iter``) draws anew from one ``random.Random(seed)``."""

    def __init__(self, clip_index: VideoClipIndex, max_clips_per_video: int,
                 seed: int | None = None):
        self.clip_index = clip_index
        self.max_clips_per_video = max_clips_per_video
        self.rng = random.Random(seed)

    def __iter__(self):
        idxs = []
        cum = self.clip_index.cumulative
        for vi in range(len(cum) - 1):
            take = min(cum[vi + 1] - cum[vi], self.max_clips_per_video)
            if take > 0:
                idxs.extend(self.rng.sample(range(cum[vi], cum[vi + 1]), take))
        self.rng.shuffle(idxs)
        return iter(idxs)

    def __len__(self):
        cum = self.clip_index.cumulative
        return sum(min(cum[i + 1] - cum[i], self.max_clips_per_video)
                   for i in range(len(cum) - 1))
