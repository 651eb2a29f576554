"""DAVIS-2017 J&F (counterpart of ``videowalk_tpu/eval/davis_metrics.py``;
the official ``davis2017-evaluation`` semi-supervised protocol).

Array core (numpy and scipy only, so it runs where cv2 and PIL are absent):

- ``jaccard``: per-object per-frame IoU, empty/empty scores 1;
- ``seg2bmap``: the official boundary map (east/south/south-east
  transitions, background-side pixels included);
- ``f_measure``: boundary precision/recall matched within a disk of radius
  ``ceil(0.008 * ||shape||)``. The dilation is
  ``scipy.ndimage.binary_dilation`` with the disk and a zero border, which
  for a symmetric structuring element is ``cv2.dilate``'s result bit for
  bit.

File shell (PIL, and cv2 only to resize a prediction of another size):
``evaluate_sequence`` (frames 1..N-2 per object), ``evaluate_davis`` (the
mean over all (sequence, object) tracks) and the CLI:

    python -m videowalk_tpu_torch.eval.davis_metrics \\
        --results <indexed PNGs per video> --davis <DAVIS root>
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
from scipy import ndimage


def jaccard(pred: np.ndarray, gt: np.ndarray) -> float:
    """IoU for one object mask pair; empty/empty scores 1."""
    inter = np.logical_and(pred, gt).sum()
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return 1.0
    return float(inter) / float(union)


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Binary boundary map: a pixel is boundary iff it differs from its east,
    south or south-east neighbour; the last row and column compare east and
    south only, and the corner is 0."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def _disk(radius: int) -> np.ndarray:
    """skimage.morphology.disk: pixels with dx^2 + dy^2 <= r^2."""
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.uint8)


def dilate(mask: np.ndarray, se: np.ndarray) -> np.ndarray:
    """Binary dilation of ``mask`` by the symmetric ``se``, zero outside.
    Only the mask's bounding box grown by the radius can be set, so the
    dilation runs on that crop (exact: the crop holds every set pixel, and
    what lies past its edges is zero)."""
    out = np.zeros(mask.shape, bool)
    rows, cols = np.flatnonzero(mask.any(1)), np.flatnonzero(mask.any(0))
    if rows.size == 0:
        return out
    r = se.shape[0] // 2
    y0, y1 = max(rows[0] - r, 0), rows[-1] + r + 1
    x0, x1 = max(cols[0] - r, 0), cols[-1] + r + 1
    out[y0:y1, x0:x1] = ndimage.binary_dilation(
        mask[y0:y1, x0:x1], structure=se.astype(bool), border_value=0)
    return out


def f_measure(pred: np.ndarray, gt: np.ndarray,
              bound_th: float = 0.008) -> float:
    """Boundary F-measure (official ``db_eval_boundary``)."""
    fg = seg2bmap(pred)
    gtb = seg2bmap(gt)
    n_fg, n_gt = int(fg.sum()), int(gtb.sum())
    if n_fg == 0 and n_gt == 0:
        return 1.0
    if n_fg == 0 or n_gt == 0:
        return 0.0              # official: (P, R) = (1, 0) or (0, 1)
    bound_pix = (int(bound_th) if bound_th >= 1 else
                 int(math.ceil(bound_th * np.linalg.norm(pred.shape))))
    se = _disk(bound_pix)
    fg_dil = dilate(fg, se)
    gt_dil = dilate(gtb, se)
    precision = np.logical_and(fg, gt_dil).sum() / n_fg
    recall = np.logical_and(gtb, fg_dil).sum() / n_gt
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def _read_indexed(path: str) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(path))


def evaluate_sequence(pred_dir: str, gt_dir: str
                      ) -> dict[int, dict[str, float]]:
    """Per-object mean J and F over frames 1..N-2 (the official tool drops
    the first and the last frame)."""
    frames = sorted(f for f in os.listdir(gt_dir) if f.endswith(".png"))
    gt0 = _read_indexed(os.path.join(gt_dir, frames[0]))
    objects = sorted(int(o) for o in np.unique(gt0) if o not in (0, 255))
    if not objects:
        return {}

    js = {o: [] for o in objects}
    fs = {o: [] for o in objects}
    for fname in frames[1:-1]:
        gt = _read_indexed(os.path.join(gt_dir, fname))
        pred_path = os.path.join(pred_dir, fname)
        pred = (_read_indexed(pred_path) if os.path.exists(pred_path)
                else np.zeros_like(gt))
        if pred.shape != gt.shape:
            import cv2

            pred = cv2.resize(pred.astype(np.uint8),
                              (gt.shape[1], gt.shape[0]),
                              interpolation=cv2.INTER_NEAREST)
        for o in objects:
            js[o].append(jaccard(pred == o, gt == o))
            fs[o].append(f_measure(pred == o, gt == o))

    return {o: {"J": float(np.mean(js[o])), "F": float(np.mean(fs[o]))}
            for o in objects}


def evaluate_davis(results_dir: str, davis_root: str,
                   split: str = "val") -> dict[str, float]:
    """Global J&F over a DAVIS-2017 split: the mean over every (sequence,
    object) track, as the official tool's J['M'] and F['M']."""
    val_list = os.path.join(davis_root, "ImageSets", "2017", f"{split}.txt")
    with open(val_list) as f:
        videos = [line.strip() for line in f if line.strip()]
    ann = os.path.join(davis_root, "Annotations", "480p")

    all_j: list[float] = []
    all_f: list[float] = []
    for v in videos:
        per_obj = evaluate_sequence(os.path.join(results_dir, v),
                                    os.path.join(ann, v))
        for o, scores in sorted(per_obj.items()):
            print(f"{v}_{o}: J={scores['J']:.4f} F={scores['F']:.4f}",
                  flush=True)
            all_j.append(scores["J"])
            all_f.append(scores["F"])
    if not all_j:
        # blank annotations, an empty split or a mis-rooted tree must not
        # read as a perfect score
        raise ValueError(
            f"no object tracks evaluated: {len(videos)} sequence(s) from "
            f"{val_list} yielded zero first-frame object ids under {ann}")
    J = float(np.mean(all_j))
    F = float(np.mean(all_f))
    out = {"J&F-Mean": (J + F) / 2, "J-Mean": J, "F-Mean": F}
    print({k: round(v, 4) for k, v in out.items()}, flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--results", required=True)
    parser.add_argument("--davis", required=True)
    parser.add_argument("--split", default="val")
    args = parser.parse_args(argv)
    evaluate_davis(args.results, args.davis, args.split)


if __name__ == "__main__":
    main()
