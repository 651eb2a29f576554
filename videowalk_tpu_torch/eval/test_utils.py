"""Prediction post-processing (counterpart of
``videowalk_tpu/eval/test_utils.py``; reference ``code/utils/test_utils.py``):
dumping, pose extraction and skeleton drawing. cv2, PIL and matplotlib
are imported inside the functions that need them: only file-based eval
does. Images are written by PIL as imageio's pillow plugin writes them
(the same bytes as the reference's ``imageio.imwrite``), so no imageio is
needed."""

from __future__ import annotations

import numpy as np


def infer_downscale(map_scale: int = 8) -> np.ndarray:
    """Feature-map downscale factor per axis (from the encoder spec)."""
    return np.array([map_scale, map_scale])


def dump_predictions(pred: np.ndarray, lbl_set: np.ndarray, img: np.ndarray,
                     prefix: str, heatmap: bool = False,
                     img_is_unit_scale: bool | None = None):
    """Save ``{prefix}_blend.jpg`` and the indexed-color mask png for one
    frame (reference ``code/utils/test_utils.py:85-123``).

    Args:
      pred: (h, w, L) soft labels at feature resolution.
      lbl_set: (L, 3) or (L, 1) label colors.
      img: (H, W, 3) original frame: uint8, or float in [0, 1] or [0, 255].
      heatmap: also build the object-1 jet heatmap blend (third return
        value; never written, as in the reference).
      img_is_unit_scale: whether a float ``img`` is in [0, 1]; None guesses
        from its largest value (<= 1.5).
    Returns:
      The blend, the mask colors and the heatmap blend (or None).
    """
    import cv2
    from PIL import Image

    if img.dtype != np.uint8:
        unit = (img.max() <= 1.5 if img_is_unit_scale is None
                else img_is_unit_scale)
        img = np.uint8(np.clip(img * 255 if unit else img, 0, 255))
    sz = img.shape[:-1]
    pred_dist = cv2.resize(pred, sz[::-1])
    if pred_dist.ndim == 2:
        pred_dist = pred_dist[..., None]

    pred_lbl = np.asarray(lbl_set).astype(np.int32)[np.argmax(pred_dist, -1)]
    if pred_lbl.ndim == 2:
        pred_lbl = pred_lbl[..., None]
    if pred_lbl.shape[-1] == 1:
        pred_lbl = np.repeat(pred_lbl, 3, axis=-1)
    img_with_label = np.float32(img) * 0.5 + np.float32(pred_lbl) * 0.5

    img_with_heatmap = None
    if heatmap:
        from matplotlib import cm

        ch = min(1, pred_dist.shape[-1] - 1)
        pred_soft = cv2.resize(pred_dist[..., ch],
                               (img.shape[1], img.shape[0]),
                               interpolation=cv2.INTER_NEAREST)
        pred_soft = cm.jet(np.clip(pred_soft, 0, 1))[..., :3] * 255.0
        img_with_heatmap = np.float32(img) * 0.5 + np.float32(pred_soft) * 0.5

    Image.fromarray(np.uint8(img_with_label)).save(f"{prefix}_blend.jpg")
    if len(prefix) >= 4 and prefix[-4] == ".":  # reference's path hack
        maskname = prefix[:-3] + "png" if prefix.endswith(".jpg") \
            else prefix.replace("jpg", "png")
    else:
        maskname = f"{prefix}_mask.png"
    Image.fromarray(np.uint8(pred_lbl)).save(maskname, compress_level=1)
    return img_with_label, pred_lbl, img_with_heatmap


def process_pose(pred: np.ndarray, lbl_set, topk: int = 3):
    """Keypoints ``(2, J)`` (x, y on the feature grid; -1 where a joint's
    map is all zero) as the top-k weighted average of each joint channel
    after the background channel, and a sharp (h, w, 3) map of them
    (reference test_utils.py:59-82)."""
    pred = pred[..., 1:]
    h, w, J = pred.shape
    flat = pred.reshape(-1, J)
    topk = min(flat.shape[0], topk)
    ids = np.argsort(-flat, axis=0)[:topk]
    vals = np.take_along_axis(flat, ids, axis=0)
    denom = vals.sum(0, keepdims=True)
    denom[denom == 0] = 1.0
    vals = vals / denom
    xx, yy = ids % w, ids // w
    coords = np.stack([(xx * vals).sum(0), (yy * vals).sum(0)], axis=0)
    coords[:, flat.sum(0) == 0] = -1

    pred_sharp = np.zeros((h, w, 3))
    for t in range(len(lbl_set) - 1):
        x, y = int(coords[0, t]), int(coords[1, t])
        if x >= 0 and y >= 0 and y < h and x < w:
            pred_sharp[y, x, :] = lbl_set[t + 1]
    return coords, pred_sharp


# JHMDB skeleton parent table (reference test_utils.py:12-26)
_POSE_PARENTS = np.zeros(15, int)
for _child, _parent in [(2, 0), (12, 8), (8, 4), (4, 0), (11, 7), (7, 3),
                        (3, 0), (0, 1), (14, 10), (10, 6), (6, 1), (13, 9),
                        (9, 5), (5, 1)]:
    _POSE_PARENTS[_child] = _parent

_POSE_COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
                [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
                [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
                [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255]]


def vis_pose(ori_img: np.ndarray, points: np.ndarray) -> np.ndarray:
    """A copy of ``ori_img`` with the JHMDB skeleton of ``points`` (2, J)
    drawn on it (reference test_utils.py:10-48)."""
    import cv2

    canvas = np.array(ori_img, copy=True)
    x, y = points[0, :], points[1, :]
    for n in range(len(x)):
        pid = int(_POSE_PARENTS[n]) if n < len(_POSE_PARENTS) else 0
        x1, y1 = int(x[pid]), int(y[pid])
        x2, y2 = int(x[n]), int(y[n])
        if x1 >= 0 and y1 >= 0 and x2 >= 0 and y2 >= 0:
            cv2.line(canvas, (x1, y1), (x2, y2), _POSE_COLORS[n], 8)
    return canvas
