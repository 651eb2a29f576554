"""JHMDB PCK@{0.1..0.5} (counterpart of ``videowalk_tpu/eval/eval_pck.py``;
reference ``code/eval/eval_pck.py``).

Array core, numpy only: ``pck_scores`` rescales keypoints from the
feature grid (``feat_res=(W, H)``, 40x40 at the reference's cropSize-320
eval) to the image size, normalizes each distance by 0.6x the ground
truth's bounding-box diagonal of that frame over the visible joints, skips
frame 0 and invisible joints, and averages over joints per threshold.

File shell: ``load_gt`` (``joint_positions.mat`` with scipy.io, the first
frame's size with cv2), ``compute_pck`` over ``{i}.dat`` dumps, and the CLI:

    python -m videowalk_tpu_torch.eval.eval_pck --filelist <list> \\
        --src <preds> [--feat-res W [H]]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

FEAT_RES = 40
THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5)
N_JOINTS = 15


def pck_scores(gts, preds, sizes, thresholds=THRESHOLDS,
               feat_res=(FEAT_RES, FEAT_RES)) -> dict[float, float]:
    """PCK per threshold, in percent.

    Args:
      gts: per video, ``(2, J, T)`` 0-indexed image coordinates.
      preds: per video, ``(2, J, T')`` keypoints on the feature grid, x
        then y; a negative x marks an invisible joint.
      sizes: per video, the frame's ``(height, width)``.
      feat_res: ``(W_feat, H_feat)`` of the grid the keypoints live on.
    """
    wf, hf = feat_res
    dist_all = {p: [] for p in range(N_JOINTS)}
    for gt, pred, (height, width) in zip(gts, preds, sizes):
        pred = np.asarray(pred).astype(np.float64)
        visible = (pred[0] >= 0)
        pred = pred.copy()
        pred[0] = pred[0] / wf * width
        pred[1] = pred[1] / hf * height

        n_joints, n_frames = gt.shape[1], min(gt.shape[2], pred.shape[2])
        boxes = np.zeros(n_frames)
        for k in range(n_frames):
            vis = visible[:, k][:n_joints]
            if not vis.any():
                boxes[k] = 1.0
                continue
            pts = gt[:, :n_joints, k][:, vis]
            boxes[k] = 0.6 * np.linalg.norm(
                [pts[0].max() - pts[0].min(), pts[1].max() - pts[1].min()])

        for j in range(n_joints):
            for k in range(1, n_frames):      # frame 0 is given
                if not visible[j, k]:
                    continue
                d = np.linalg.norm(pred[:2, j, k] - gt[:2, j, k])
                dist_all[j].append(d / max(boxes[k], 1e-12))

    results = {}
    for th in thresholds:
        pcks = [100.0 * np.mean(np.asarray(dist_all[p]) <= th)
                for p in range(N_JOINTS) if dist_all[p]]
        results[th] = float(np.mean(pcks))
        print(f"{th}: {results[th]:.2f}")
    return results


def load_gt(filelist: str):
    """Ground-truth tracks (0-indexed) and the frame sizes of a filelist of
    ``<frame dir> <joint_positions.mat>`` lines."""
    import cv2
    import scipy.io as sio

    gts, heights, widths = [], [], []
    with open(filelist) as f:
        for line in f:
            rows = line.strip().split()
            if not rows:
                continue
            lbls_mat = sio.loadmat(rows[1])
            gts.append(lbls_mat["pos_img"].astype(np.float64) - 1)
            # the reference reads '00001.png'; where it is missing, the
            # folder's first frame
            imgpath = rows[0] + "/00001.png"
            if not os.path.exists(imgpath):
                cands = sorted(
                    f for f in os.listdir(rows[0])
                    if f.lower().endswith((".png", ".jpg", ".jpeg")))
                if not cands:
                    raise IOError(f"no frames found under {rows[0]}")
                imgpath = os.path.join(rows[0], cands[0])
            img = cv2.imread(imgpath)
            if img is None:
                raise IOError(f"could not read frame {imgpath}")
            heights.append(img.shape[0])
            widths.append(img.shape[1])
    return gts, heights, widths


def compute_pck(filelist: str, src_folder: str,
                thresholds=THRESHOLDS,
                feat_res=(FEAT_RES, FEAT_RES)) -> dict[float, float]:
    """PCK of the ``{i}.dat`` keypoints under ``src_folder`` (``feat_res``:
    ``(W_feat, H_feat)``; pass the true grid for any eval geometry other
    than the reference's cropSize 320)."""
    gts, heights, widths = load_gt(filelist)
    preds = [np.load(f"{src_folder.rstrip('/')}/{i}.dat", allow_pickle=True)
             for i in range(len(gts))]
    return pck_scores(gts, preds, list(zip(heights, widths)), thresholds,
                      feat_res)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--filelist", required=True)
    parser.add_argument("--src", required=True,
                        help="folder with {i}.dat prediction files")
    parser.add_argument("--feat-res", nargs="+", type=int,
                        default=[FEAT_RES],
                        help="W [H] of the keypoint feature grid (default "
                             "40 40, the cropSize-320 eval; e.g. '40 30' "
                             "for native 320x240 JHMDB)")
    args = parser.parse_args(argv)
    fr = args.feat_res
    compute_pck(args.filelist, args.src,
                feat_res=(fr[0], fr[1] if len(fr) > 1 else fr[0]))


if __name__ == "__main__":
    main()
