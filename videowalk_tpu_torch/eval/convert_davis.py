"""Predicted color masks -> indexed DAVIS PNGs at the annotations' size
(counterpart of ``videowalk_tpu/eval/convert_davis.py``; reference
``code/eval/convert_davis.py``).

``color2id_map`` is the array core (numpy only). ``convert_video`` reads
``{vid_idx}_{j}_mask.png`` with cv2, maps colors to palette ids, resizes
nearest to the annotation size and writes a palettized PNG with PIL.

    python -m videowalk_tpu_torch.eval.convert_davis -i <masks> -o <out> \\
        -d <DAVIS root>
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from videowalk_tpu_torch.eval import palette as palette_mod
from videowalk_tpu_torch.utils.colors import pack_rgb

PALETTE = palette_mod.tensor.astype(np.uint8)

# the 256 palette colors are distinct: a packed color's sorted position
# finds its id
_PAL_PACKED = pack_rgb(PALETTE)
_PAL_ORDER = np.argsort(_PAL_PACKED)
_PAL_SORTED = _PAL_PACKED[_PAL_ORDER]


def color2id_map(lblimg: np.ndarray) -> np.ndarray:
    """(H, W, 3) color mask -> (H, W) uint8 palette ids; colors outside the
    palette map to 0, as in the reference."""
    packed = pack_rgb(lblimg.reshape(-1, 3))
    pos = np.searchsorted(_PAL_SORTED, packed).clip(0, len(_PAL_SORTED) - 1)
    cand = _PAL_ORDER[pos]
    out = np.where(_PAL_PACKED[cand] == packed, cand, 0).astype(np.uint8)
    return out.reshape(lblimg.shape[:2])


def convert_video(vid_idx: int, video_name: str, in_folder: str,
                  out_folder: str, annotations_folder: str) -> None:
    import cv2
    from PIL import Image

    gtfolder = os.path.join(annotations_folder, video_name)
    outfolder = os.path.join(out_folder, video_name)
    os.makedirs(outfolder, exist_ok=True)

    files = [f for f in os.listdir(gtfolder) if f.endswith(".png")]
    lblimg = cv2.imread(os.path.join(gtfolder, "00000.png"))
    height, width = lblimg.shape[:2]

    for j in range(len(files)):
        # no channel flip: the dataset read the annotations with cv2 (BGR),
        # the dump wrote those triples as RGB, and cv2 reads them back as
        # BGR, so the two flips cancel as in the reference
        lblimg = cv2.imread(os.path.join(in_folder, f"{vid_idx}_{j}_mask.png"))
        lblidx = cv2.resize(color2id_map(lblimg), (width, height),
                            interpolation=cv2.INTER_NEAREST).astype(np.uint8)
        im = Image.fromarray(lblidx)
        im.putpalette(PALETTE.ravel())
        im.save(os.path.join(outfolder, f"{j:05d}.png"), format="PNG")


def convert_all(in_folder: str, out_folder: str, dataset_root: str,
                workers: int = 10) -> list[str]:
    annotations = os.path.join(dataset_root, "Annotations", "480p")
    val_list = os.path.join(dataset_root, "ImageSets", "2017", "val.txt")
    with open(val_list) as f:
        videos = [line.strip() for line in f if line.strip()]
    os.makedirs(out_folder, exist_ok=True)
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(
            lambda iv: convert_video(iv[0], iv[1], in_folder, out_folder,
                                     annotations),
            enumerate(videos)))
    return videos


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-o", "--out_folder", required=True, type=str)
    parser.add_argument("-i", "--in_folder", required=True, type=str)
    parser.add_argument("-d", "--dataset", required=True, type=str)
    args = parser.parse_args(argv)
    convert_all(args.in_folder, args.out_folder, args.dataset)


if __name__ == "__main__":
    main()
