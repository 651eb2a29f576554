"""JHMDB pose dataset for keypoint propagation (counterpart of
``videowalk_tpu/data/jhmdb.py``; reference ``code/data/jhmdb.py``).

Frames with ``videoLen`` frame-0 copies prepended, square resize to
``imgSize`` when it is positive, ImageNet normalization; the 15 joints of
``joint_positions.mat`` drawn as Gaussian heatmaps at feature resolution
(``draw_labelmap_np``) behind a background channel. The label colors are
``cm.Paired``'s (joint i takes color ``i % 12``), kept as a constant so
that no matplotlib is needed. cv2 and scipy.io are imported when a video
is read.
"""

from __future__ import annotations

import math
import os

import numpy as np

from videowalk_tpu_torch.data.vos import (IMAGENET_MEAN, IMAGENET_STD,
                                          load_image, resize_hw)
from videowalk_tpu_torch.utils.colors import PAIRED


def draw_labelmap_np(img, pt, sigma, kind="Gaussian"):
    """Stamp a truncated 2D Gaussian (or Cauchy) bump into ``img`` at ``pt``
    (reference jhmdb.py:287-319): centred on the int-truncated window
    origin plus half the window, values inside the (6 sigma + 1)-wide
    window overwrite the image, everything outside is untouched."""
    h, w = img.shape
    ux, uy = int(pt[0] - 3 * sigma), int(pt[1] - 3 * sigma)
    bx, by = int(pt[0] + 3 * sigma + 1), int(pt[1] + 3 * sigma + 1)
    if ux >= w or uy >= h or bx < 0 or by < 0:
        return img                          # bump entirely off the image
    size = 6 * sigma + 1
    cx, cy = ux + size // 2, uy + size // 2
    xs = np.arange(w, dtype=float)[None, :]
    ys = np.arange(h, dtype=float)[:, None]
    d2 = (xs - cx) ** 2 + (ys - cy) ** 2
    if kind == "Gaussian":
        g = np.exp(-d2 / (2 * sigma ** 2))
    else:  # Cauchy
        g = sigma / ((d2 + sigma ** 2) ** 1.5)
    inside = (xs >= ux) & (xs < bx) & (ys >= uy) & (ys < by)
    img[inside] = g[inside]
    return img


def pose_labels(lbls_coord: np.ndarray, rsz_h: int, rsz_w: int,
                sigma: float) -> np.ndarray:
    """``(T, rsz_h, rsz_w, J)`` heatmaps of keypoints ``(2, J, T)`` given on
    the feature grid: a Gaussian bump a joint (``sigma > 0``) or its one
    cell."""
    n_joints, n_frames = lbls_coord.shape[1], lbls_coord.shape[2]
    lbls = np.zeros((n_frames, rsz_h, rsz_w, n_joints))
    for i in range(n_frames):
        for j in range(n_joints):
            if sigma > 0:
                draw_labelmap_np(lbls[i, :, :, j], lbls_coord[:, j, i], sigma)
            else:
                tx, ty = int(lbls_coord[0, j, i]), int(lbls_coord[1, j, i])
                if 0 <= tx < rsz_w and 0 <= ty < rsz_h:
                    lbls[i, ty, tx, j] = 1.0
    return lbls


def pose_label_buffer(lbls: np.ndarray, video_len: int) -> np.ndarray:
    """The eval's label buffer ``(video_len + T, h, w, 1 + J)`` float32:
    frame 0's maps for the prefix, then each frame's, behind the background
    channel (1 where no joint's map is set)."""
    frame_num = video_len + len(lbls)
    out = np.zeros((frame_num, *lbls.shape[1:]), np.float32)
    for i in range(frame_num):
        out[i] = lbls[0 if i < video_len else min(i - video_len,
                                                  len(lbls) - 1)]
    bg = (out.sum(-1) == 0)[..., None].astype(np.float32)
    return np.concatenate([bg, out], axis=-1)


def pose_lblset(n_joints: int) -> np.ndarray:
    """``(1 + J, 3)`` label colors: black, then ``cm.Paired(i % 12)``."""
    return np.array([[0, 0, 0]] + [PAIRED[i % 12]
                                   for i in range(n_joints)]) * 255.0


class JhmdbSet:
    def __init__(self, args, sigma: float = 0.5):
        self.filelist = args.filelist
        self.imgSize = args.imgSize
        self.videoLen = args.videoLen
        self.mapScale = args.mapScale
        self.sigma = sigma
        self.workers = int(getattr(args, "workers", 0) or 0)

        self.jpgfiles, self.lblfiles = [], []
        with open(self.filelist) as f:
            for line in f:
                rows = line.split()
                if rows:
                    self.jpgfiles.append(rows[0])
                    self.lblfiles.append(rows[1])

    def __len__(self):
        return len(self.jpgfiles)

    def make_paths(self, folder_path):
        I = sorted((ll for ll in os.listdir(folder_path) if ".png" in ll),
                   key=lambda x: int(x.split(".")[0]))
        return [os.path.join(folder_path, I[max(0, i - self.videoLen)])
                for i in range(len(I) + self.videoLen)]

    def __getitem__(self, index):
        import scipy.io as sio

        from videowalk_tpu_torch.data.decode import decode_unique

        folder_path = self.jpgfiles[index]
        img_paths = self.make_paths(folder_path)

        def _decode_one(p):
            img = load_image(p)
            ht, wd = img.shape[:2]
            if self.imgSize > 0:
                img = resize_hw(img, self.imgSize, self.imgSize)
            norm = ((img - np.asarray(IMAGENET_MEAN, np.float32))
                    / np.asarray(IMAGENET_STD, np.float32))
            return norm, img, (ht, wd)

        decoded = decode_unique(img_paths, _decode_one, self.workers)
        imgs = np.stack([decoded[p][0] for p in img_paths]).astype(np.float32)
        imgs_orig = np.stack([decoded[p][1] for p in img_paths]
                             ).astype(np.float32)
        ht, wd = decoded[img_paths[-1]][2]
        newh = neww = self.imgSize if self.imgSize > 0 else None
        if newh is None:
            newh, neww = ht, wd
        rsz_h = math.ceil(newh / self.mapScale[0])
        rsz_w = math.ceil(neww / self.mapScale[1])

        lbls_coord = sio.loadmat(self.lblfiles[index])["pos_img"].astype(
            np.float64) - 1
        # to the feature grid: x by the width scale, y by the height scale
        # (the reference swaps the two map scales, which are always equal)
        lbls_coord[0] = lbls_coord[0] * float(neww) / float(wd) / self.mapScale[1]
        lbls_coord[1] = lbls_coord[1] * float(newh) / float(ht) / self.mapScale[0]

        lbls = pose_label_buffer(
            pose_labels(lbls_coord, rsz_h, rsz_w, self.sigma), self.videoLen)
        meta = dict(folder_path=folder_path, img_paths=img_paths,
                    lbl_paths=[])
        return imgs, imgs_orig, lbls, lbls, pose_lblset(lbls_coord.shape[1]), meta
