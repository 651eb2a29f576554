"""VIP 20-class parsing metrics: pixel accuracy, mean accuracy, mIoU and
fwIoU (counterpart of ``videowalk_tpu/eval/eval_vip.py``; reference
``code/eval/eval_vip.py``).

Array core, numpy only: ``fast_hist`` (the confusion histogram of (gt,
pred) ids, out-of-class pixels on either side dropped) and ``show_result``
(the four statistics; an empty histogram raises). File shell:
``compute_hist`` over (prediction, GT) PNG pairs, and the CLI:

    python -m videowalk_tpu_torch.eval.eval_vip -g <gt_dir> -p <pred_dir>
"""

from __future__ import annotations

import argparse
import os

import numpy as np

N_CL = 20
CLASSES = ["background", "hat", "hair", "sun-glasses", "upper-clothes",
           "dress", "coat", "socks", "pants", "gloves", "scarf", "skirt",
           "torso-skin", "face", "right-arm", "left-arm", "right-leg",
           "left-leg", "right-shoe", "left-shoe"]


def fast_hist(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """(n, n) counts of (a, b) id pairs; pairs with either id outside
    [0, n) are dropped."""
    k = (a >= 0) & (a < n) & (b >= 0) & (b < n)
    return np.bincount(n * a[k].astype(int) + b[k],
                       minlength=n ** 2).reshape(n, n)


def compute_hist(pre_dir: str, gt_dir: str) -> np.ndarray:
    """The histogram over every ``<pre_dir>/<video>/<frame>`` prediction
    with a ``<gt_dir>/<video>/<frame>.png``; the prediction is resized
    nearest to the GT and read from its last channel."""
    import cv2
    from PIL import Image

    hist = np.zeros((N_CL, N_CL))
    for vid in sorted(os.listdir(pre_dir)):
        vdir = os.path.join(pre_dir, vid)
        if not os.path.isdir(vdir):
            continue
        for img_name in sorted(os.listdir(vdir)):
            img_path = os.path.join(vdir, img_name)
            label_path = os.path.join(gt_dir, vid,
                                      img_name.replace(".jpg", ".png"))
            if not os.path.exists(label_path):
                continue            # blend jpgs have no GT frame
            label_array = np.array(Image.open(label_path), dtype=np.int32)
            image = cv2.imread(img_path)
            if image.shape[:2] != label_array.shape[:2]:
                image = cv2.resize(
                    image, (label_array.shape[1], label_array.shape[0]),
                    interpolation=cv2.INTER_NEAREST)
            image_array = np.array(image, dtype=np.int32)
            if image_array.ndim == 3:
                image_array = image_array[..., -1]
            hist += fast_hist(label_array, image_array, N_CL)
    return hist


def show_result(hist: np.ndarray) -> dict[str, float]:
    """Overall accuracy, mean accuracy, mIoU and fwIoU of a histogram."""
    if hist.sum() == 0:
        raise RuntimeError(
            "empty confusion histogram: no prediction/GT file pairs "
            "overlapped — check that -p points at the dumped 'videos/' "
            "masks and -g at the matching GT root (a silent NaN here "
            "would read as a finished eval)")
    num_cor_pix = np.diag(hist)
    num_gt_pix = hist.sum(1)
    print("=" * 50)
    overall = num_cor_pix.sum() / hist.sum()
    print(">>> overall accuracy", overall)
    print("-" * 50)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = num_cor_pix / num_gt_pix
        for i in range(N_CL):
            print("%-15s: %f" % (CLASSES[i], acc[i]))
        mean_acc = np.nanmean(acc)
        print(">>> mean accuracy", mean_acc)
        print("-" * 50)
        union = num_gt_pix + hist.sum(0) - num_cor_pix
        iu = num_cor_pix / union
        for i in range(N_CL):
            print("%-15s: %f" % (CLASSES[i], iu[i]))
        miou = np.nanmean(iu)
        print(">>> mean IU", miou)
        print("-" * 50)
        freq = num_gt_pix / hist.sum()
        fwiou = (freq[freq > 0] * iu[freq > 0]).sum()
        print(">>> fwavacc", fwiou)
    print("=" * 50)
    return {"overall_acc": float(overall), "mean_acc": float(mean_acc),
            "mIoU": float(miou), "fwIoU": float(fwiou)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-g", "--gt_dir", type=str, required=True)
    parser.add_argument("-p", "--pre_dir", type=str, required=True)
    args = parser.parse_args(argv)
    show_result(compute_hist(args.pre_dir, args.gt_dir))


if __name__ == "__main__":
    main()
