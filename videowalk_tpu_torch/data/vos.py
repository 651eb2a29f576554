"""DAVIS-style VOS dataset for label propagation (counterpart of
``videowalk_tpu/data/vos.py``; reference ``code/data/vos.py``).

- filelist of ``<jpeg_dir> <annotation_dir>`` lines;
- ``videoLen`` copies of frame 0 prepended;
- square resize to ``imgSize`` when it is positive, with ImageNet
  normalization on the host; at ``imgSize <= 0`` (native size, the config
  of record) frames stay raw uint8 RGB and are normalized on the device;
- label set from frame 0's unique colors (one channel when the palette is
  consecutive);
- one-hot and feature-resolution label caches saved next to the data
  (``*_onehot.npy`` / ``*_size{h}x{w}.npy``);
- the striped ``--texture`` label mode and LAB color (``use_lab``, set for
  ``uvc``): the L channel in [-1, 1] in all three channels.

cv2 is imported when a video is read.
"""

from __future__ import annotations

import math
import os

import numpy as np

from videowalk_tpu_torch.utils.colors import PAIRED, pack_rgb

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def load_image(path: str) -> np.ndarray:
    """BGR file -> float32 RGB (H, W, 3) in [0, 1]."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise IOError(f"cannot read image: {path}")
    return (img.astype(np.float32) / 255.0)[:, :, ::-1].copy()


def resize_hw(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize to (h, w)."""
    import cv2

    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


def make_lbl_set(lbls: np.ndarray) -> np.ndarray:
    """Unique frame-0 colors as the label set, in lexicographic order."""
    flat = lbls[0].reshape(-1, lbls.shape[-1]).astype(np.uint8)
    if flat.shape[-1] != 3:
        return np.unique(flat, axis=0)
    u = np.unique(pack_rgb(flat))
    return np.stack([(u >> 16) & 0xFF, (u >> 8) & 0xFF, u & 0xFF],
                    axis=-1).astype(np.uint8)


def onehot_from_lblset(lbl: np.ndarray, lblset: np.ndarray) -> np.ndarray:
    """Per-pixel boolean one-hot against the label set."""
    if lbl.shape[-1] == 3 and lblset.shape[-1] == 3:
        return pack_rgb(lbl.astype(np.uint8))[..., None] == \
            pack_rgb(lblset.astype(np.uint8))
    return np.stack([np.all(lbl == ll, axis=-1) for ll in lblset], axis=-1)


def texturize(onehot: np.ndarray) -> np.ndarray:
    """Striped-label mode (reference vos.py:77-101): the rows where any
    object appears are split into up to 10 horizontal stripes."""
    hidxs = [h for h in range(onehot.shape[0])
             if np.any(onehot[h, :, 1:] == 1)]
    nstripes = min(10, len(hidxs))
    out = np.zeros((*onehot.shape[:2], nstripes + 1))
    out[:, :, 0] = 1
    for i, h in enumerate(hidxs):
        cidx = int(i // (len(hidxs) / nstripes))
        w = np.any(onehot[h, :, 1:] == 1, axis=-1)
        out[h][w] = 0
        out[h][w, cidx + 1] = 1
    return out


def try_np_load(p):
    """A label cache, or None when it is missing or unreadable."""
    try:
        return np.load(p)
    except (OSError, ValueError, EOFError):
        return None


class VOSDataset:
    def __init__(self, args):
        self.texture = bool(getattr(args, "texture", False))
        self.use_lab = bool(getattr(args, "use_lab", False))
        self.filelist = args.filelist
        self.imgSize = args.imgSize
        self.videoLen = args.videoLen
        self.mapScale = args.mapScale
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

    def make_paths(self, folder_path, label_path):
        """Frame paths with ``videoLen`` frame-0 copies prepended."""
        I = sorted(os.listdir(folder_path), key=lambda x: int(x.split(".")[0]))
        L = sorted((ll for ll in os.listdir(label_path) if "npy" not in ll),
                   key=lambda x: int(x.split(".")[0]))
        I_out, L_out = [], []
        for i in range(len(I) + self.videoLen):
            i = max(0, i - self.videoLen)
            I_out.append(os.path.join(folder_path, I[i]))
            L_out.append(os.path.join(label_path, L[i]))
        return I_out, L_out

    def __getitem__(self, index):
        import cv2

        img_paths, lbl_paths = self.make_paths(self.jpgfiles[index],
                                               self.lblfiles[index])
        raw_u8 = self.imgSize <= 0 and not self.use_lab

        def _decode_one(pair):
            ip, lp = pair
            lblimg = cv2.imread(lp)
            if raw_u8:
                bgr = cv2.imread(ip)
                if bgr is None:
                    raise IOError(f"cannot read image: {ip}")
                img = np.ascontiguousarray(bgr[:, :, ::-1])   # uint8 RGB
                return img, img, lblimg
            img = load_image(ip)
            if self.imgSize > 0:
                n = self.imgSize
                img = resize_hw(img, n, n)
                lblimg = cv2.resize(lblimg, (n, n),
                                    interpolation=cv2.INTER_NEAREST)
            if self.use_lab:
                u8 = (img * 255).astype(np.uint8)[:, :, ::-1]   # RGB->BGR
                lab = cv2.cvtColor(u8, cv2.COLOR_BGR2LAB)
                lab = (lab.astype(np.float32) - 128.0) / 128.0
                return np.stack([lab[..., 0]] * 3, axis=-1), img, lblimg
            norm = ((img - np.asarray(IMAGENET_MEAN, np.float32))
                    / np.asarray(IMAGENET_STD, np.float32))
            return norm, img, lblimg

        from videowalk_tpu_torch.data.decode import decode_unique

        pairs = list(zip(img_paths, lbl_paths))
        decoded = decode_unique(pairs, _decode_one, self.workers)
        imgs = [decoded[p][0] for p in pairs]
        imgs_orig = [decoded[p][1] for p in pairs]
        lbls = np.stack([decoded[p][2] for p in pairs])
        meta = dict(folder_path=self.jpgfiles[index], img_paths=img_paths,
                    lbl_paths=lbl_paths)

        lblset = make_lbl_set(lbls)
        if lblset.shape[0] > 1 and np.all((lblset[1:] - lblset[:-1]) == 1):
            lblset = lblset[:, 0:1]  # consecutive palette -> single channel

        rsz_h = math.ceil(imgs[0].shape[0] / self.mapScale[0])
        rsz_w = math.ceil(imgs[0].shape[1] / self.mapScale[1])
        resizes, cache = [], {}
        for i, p in enumerate(lbl_paths):
            if p not in cache:
                prefix = os.path.splitext(p)[0]
                oh_path = f"{prefix}_onehot.npy"
                rz_path = f"{prefix}_size{rsz_h}x{rsz_w}.npy"
                onehot = try_np_load(oh_path)
                if onehot is None:
                    onehot = onehot_from_lblset(lbls[i], lblset)
                    try:
                        np.save(oh_path, onehot)
                    except OSError:
                        pass
                resized = try_np_load(rz_path)
                if resized is None:
                    resized = cv2.resize(np.float32(onehot), (rsz_w, rsz_h),
                                         interpolation=cv2.INTER_LINEAR)
                    try:
                        np.save(rz_path, resized)
                    except OSError:
                        pass
                cache[p] = resized
            if self.texture:
                # frame 0's stripes for the videoLen prefix, zeros after;
                # the label set from cm.Paired
                striped = texturize(cache[p])
                lblset = np.array([[0, 0, 0]] + [
                    PAIRED[j] for j in range(striped.shape[-1])]) * 255.0
                resizes = [striped] * self.videoLen + [
                    np.zeros(striped.shape)] * (len(lbl_paths) - self.videoLen)
                break
            resizes.append(cache[p])

        if raw_u8:
            imgs = imgs_orig = np.stack(imgs)
        else:
            imgs = np.stack(imgs).astype(np.float32)
            imgs_orig = np.stack(imgs_orig).astype(np.float32)
        lbls_resize = np.stack(resizes).astype(np.float32)
        return imgs, imgs_orig, lbls_resize, lbls, lblset, meta
