#!/bin/bash
# Training recipe of the PyTorch port: train.sh line for line, on the card
# (--device cuda by default; add --device cpu to run on the host).
# Config of record: clip_len 4, batch 6, lr 3e-4, temp 0.05, edge dropout
# 0.1, SLIC num_sp 36, compactness 50, L1 dilation k=55, 20 epochs
# (reference code/train.sh:15-22).

DATA_PATH=${DATA_PATH:-/data/kinetics/}
CACHE_PATH=${CACHE_PATH:-cached_data/kinetics.pt}

python -m videowalk_tpu_torch.cli.train \
  --data-path "$DATA_PATH" \
  --cache-path "$CACHE_PATH" --cache-dataset \
  --frame-aug grid \
  --dropout 0.1 \
  --clip-len 4 \
  --temp 0.05 \
  --model-type scratch \
  --batch-size 6 \
  --lr 0.0003 \
  --prob 0.7 \
  --sp-method slic \
  --num-sp 36 \
  --compactness 50 \
  --dilate-superpixels \
  --dilation-kernel-shape L1 \
  --dilation-kernel-size 55 \
  --epochs 20 \
  --sp-backend device \
  --dtype bfloat16 \
  --data-parallel \
  "$@"
