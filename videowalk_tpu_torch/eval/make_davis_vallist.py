"""A DAVIS filelist for the eval CLI (counterpart of
``videowalk_tpu/eval/make_davis_vallist.py``): ``<jpeg_dir>
<annotation_dir>`` lines from any DAVIS-2017 root.

    python -m videowalk_tpu_torch.eval.make_davis_vallist --davis <root> \\
        [--split val] [--out davis_vallist.txt]
"""

from __future__ import annotations

import argparse
import os


def make_list(davis_root: str, split: str = "val") -> list[str]:
    with open(os.path.join(davis_root, "ImageSets", "2017",
                           f"{split}.txt")) as f:
        videos = [line.strip() for line in f if line.strip()]
    return [
        f"{os.path.join(davis_root, 'JPEGImages', '480p', v)} "
        f"{os.path.join(davis_root, 'Annotations', '480p', v)}"
        for v in videos
    ]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--davis", required=True)
    parser.add_argument("--split", default="val")
    parser.add_argument("--out", default="davis_vallist.txt")
    args = parser.parse_args(argv)
    lines = make_list(args.davis, args.split)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} entries to {args.out}")


if __name__ == "__main__":
    main()
