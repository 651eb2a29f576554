#!/bin/bash
# Evaluation recipe of the PyTorch port: test.sh line for line, on the card
# (--device cuda by default; add --device cpu to run on the host): label
# propagation on DAVIS-2017 -> palette conversion -> J&F. Eval config of
# record: topk 10, videoLen 20, radius 12, temperature 0.05, cropSize -1
# (reference code/test.sh:21-32). Unlike test.sh, a failed step stops the
# chain, so that no J&F is printed for results the eval did not write.

set -e

DAVIS=${DAVIS:-/data/DAVIS}
CKPT=${CKPT:-checkpoints/latest/checkpoint.pth}
OUT=${OUT:-results}
VALLIST=${VALLIST:-davis_vallist.txt}

python -m videowalk_tpu_torch.eval.make_davis_vallist --davis "$DAVIS" \
  --out "$VALLIST"

python -m videowalk_tpu_torch.cli.test \
  --filelist "$VALLIST" \
  --model-type scratch \
  --resume "$CKPT" \
  --save-path "$OUT" \
  --topk 10 --videoLen 20 --radius 12 --temperature 0.05 --cropSize -1 \
  "$@"

python -m videowalk_tpu_torch.eval.convert_davis \
  -i "$OUT" -o "${OUT}_converted" -d "$DAVIS"

python -m videowalk_tpu_torch.eval.davis_metrics \
  --results "${OUT}_converted" --davis "$DAVIS"
