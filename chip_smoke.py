#!/usr/bin/env python3
"""Smoke test of the PyTorch port's eval and training paths on one NVIDIA
card.

    python3 chip_smoke.py [--targets 40] [--steps 5] [--out results/chip_smoke.json]
    python3 chip_smoke.py --phases rconv      # phases alone, no result line

1. Prints the card's name and power limit, builds every CUDA kernel of
   ``videowalk_tpu_torch/ops/csrc`` (one nvcc each, started together).
2. Holds the block-sparse top-k propagation kernel (f32 FMAs) against its
   plain PyTorch version at DAVIS-480p geometry (C=256,
   60x107 maps, 1 long + 20 short context frames, k=10, r=12, T=0.05, 4
   labels), target by target on one shared label buffer, on random unit
   features and on near-tie features (frames that are rolled copies of one
   smooth texture plus 1e-7 noise), prints the share of queries whose top-k
   ids differ, and times both with CUDA events beside two bounds (f32
   products on the CUDA cores; the same as 3xTF32 on the tensor cores).
3. Drives the eval slice end to end through ``cli.test.test()``: a seeded
   random-init ``scratch`` CRW (ResNet-18, layer4 removed, C=256) on a
   synthetic 480x854 video with moving squares and 3 labels, 20-frame
   prefix + ``--targets`` frames. Kernel launch counts are zeroed just
   before that run and read just after it.
4. Checks the result: finite predictions of the right shape, the first
   target equal to the frame-0 ground truth, one launch per target, and the
   card's end-to-end predictions against the CPU path on a small video.
   Then the rest of the eval path in memory (``eval_tail``; the file
   path is driven by ``files``, item 19): the DAVIS J&F of that video's predictions (bilinear upsample and argmax on
   the card, J and F per object by ``eval/davis_metrics.py``'s array core,
   ground truth against itself J = F = 1); JHMDB's geometry (320x320, 40x40
   maps, 15 joints of moving squares as ``draw_labelmap_np`` heatmaps + the
   background: 16 labels) and VIP's label width (20 classes at 480x854)
   through ``cli.test.test()`` on a ``jhmdb`` / ``VIP`` filelist, #1
   counted per target and held to its plain version on the eval's own
   features at 16 and 20 labels, PCK by ``process_pose`` and the PCK core,
   mIoU by ``fast_hist`` and ``show_result``; and ``--encode-dtype
   bfloat16`` against f32 on the DAVIS frames (per-frame cosine > 0.99).

5. Holds the fused walk kernels (forward and backward, ``ops/csrc/walk.cu``,
   four device launches each) against their plain PyTorch version with
   rate-0.1 edge-drop masks at the flagship shape (B=8, T=8, N=49, C=128),
   at the gate's edge (T=10, N=128, C=512) and at the superpixel step's
   shape (B=6, T=4, N=48) with 8-14 absent node slots (all-zero rows) a
   frame, checks that two runs are bitwise equal, times both with CUDA
   events, gives each phase kernel's device time from ``torch.profiler``
   and says whether each kernel is under its plain version at the edge;
   then times the fused walk (forward + backward) against
   ``core/walk.py``'s walk over T 4/8/10, N 48-128, C 128-512 at batch 8:
   the sweep that bounds ``fused_walk="auto"`` (``models/crw.py``).
6. Holds the bf16 reflect-conv kernels (``ops/csrc/rconv_slab.cu``:
   forward #4, forward with BN moments #5, dx #9 and dW #10, and the
   BN-input chain's forward #6, which applies ``relu(a*x + b)`` to its
   operand, dx with da/db #7 and dW #8) against their plain
   PyTorch version on bf16 inputs at the step's shapes (the layer4
   interior, 3136 images of 8x8 with 512 channels; layer1's 16x16x64; 8x8
   128->256; a 32x32x512 map; the superpixel step's 24 maps of 32x32x512
   and its patch arm's 1176 of 8x8x512), and #6 on a ragged last tile with
   ``b > 0``; checks that two runs of #4, #5, #6, dW, #7 and #8 are bitwise
   equal and that planted faults fail (#4's and #5's y of a zero-padded conv, #5's
   moments without s1 or without one tile; dx without the row-1 fold leg
   of the dy=0 taps; #6's y without the ReLU on one channel vector, its
   moments with the ragged tile's empty rows counted as ``relu(b)``; #7's
   dx without its gate on one row, its da/db without a row group of every
   tile; #8's dW without the ReLU on one channel vector); and times
   kernel, plain version and the library call (``F.pad`` + cuDNN
   ``conv2d``; for each backward kernel alone, autograd of it for that
   kernel's inputs; for the chain after an elementwise affine + ReLU) with
   CUDA events. ptxas's verdict on each slab kernel: does it serialize
   ``wgmma`` (C7510-C7515), and its registers and spills? (The parent
   tree's kernels are timed by running its own ``--phases rconv`` from an
   unpacked copy in the same call.) Then the BN kernels (``bn``,
   ``ops/bn_act.py``): each pass against its plain version on the card at
   the flagship's layer4 and the
   superpixel step's 64x64 layer1, each pass's device ms at layer4 beside
   its bytes at 3.35 TB/s, and one BN with its add and ReLU forward and
   backward on the kernels and on the eager chain at both shapes. Every
   training arm reads its BN kernels' launches a step.
7. Drives the training slice: ``bench.py``'s flagship step (8-frame clips,
   batch 8, a 7x7 grid of 64 px patches, the ``scratch`` ResNet-18 with a
   bf16 trunk in BN-train mode, edge dropout 0.1, T 0.05, Adam lr 3e-4)
   from a seeded init through ``make_train_step``, in four arms one after
   another that differ only by the reflect-conv route: ``rconv='off'``
   (cuDNN), ``auto`` + ``bn_fuse='stats'``, the default ``auto`` +
   ``auto`` (every supported conv routed, the BN-input chain) and ``on`` +
   ``off`` (#4). Each arm takes 3 warm-up steps, then timed ones
   (``--steps`` for the default, 5 for the others) with every kernel count
   zeroed just before and read just after: every loss must be finite, each
   walk kernel launched once a step and each reflect-conv kernel as often
   as the route says. The default arm takes 3 more steps under
   ``torch.profiler``: device time by kernel and kind, idle share.
8. A small f32 step on the default routes (64 px patches) on the card against the same step on the CPU (plain versions),
   same weights and edge-drop masks: loss and gradients.

9. Holds the fused SLIC kernels (``ops/csrc/slic.cu``, #12) against the
   plain ``slic`` at the superpixel step of record (6 clips of 4 whole 256
   px frames, 36 segments, compactness 50, 10 rounds): equal labels after
   one assignment from the same centers (>= 99.9%, white-noise and
   structured frames) and after the full run on structured frames (>= 99%),
   a run with per-frame active counts, two runs bitwise equal; times both,
   gives each SLIC kernel's device time and the device launches of a call
   from ``torch.profiler`` and checks that a call copies nothing from the
   host; the bound counts each round's (pixel, center in its window) pairs
   at the centers the plain version holds there.
10. Holds the L1 dilation kernel (``ops/csrc/dilation.cu``, #11) to
   **equality** with its plain version on the 1152 bf16 one-hot masks of
   SLIC labels at k=55 (and k=5, and a ragged stack), checks that two
   planted faults fail (a square, a band-edge row), and times kernel, plain
   version and the library call (one ``conv2d`` with the diamond kernel,
   ``> 0``); the kernel's device µs and device launches a call from
   ``torch.profiler``.
11. Drives the superpixel training step of record through
   ``make_train_step`` with ``slic_fused`` inside the timed step: ``sp``,
   ``sp_dil`` (L1 dilation k=55; profiled, stages timed), ``sp_dil`` with
   ``rconv='off'`` and with ``rconv='on'``, and the patch step at the same
   batch 6 / clip 4; each
   asserts finite losses and its kernels' launches per step.
12. A small f32 superpixel step (64 px frames, dilation) on the card
   against the CPU with the same labels: loss, q, gradients, launches.
13. Drives the teacher-student step (``CRWTeacherStudent``, alpha 0.5) at
   the flagship config through ``make_train_step`` with the teacher frozen
   (``frozen_prefixes=("teacher.",)``): the student seeded, the teacher a
   seeded CRW's ``state_dict`` loaded under ``teacher.`` by
   ``partial_load``, as the JAX CLI loads a pretrained teacher. 3 warm-up
   steps, ``--steps`` timed ones with the counts zeroed just before and read
   just after (the teacher's eval-mode trunk on #4, 15 a step; the
   student's on the default route; no walk kernel: plain softmax takes
   ``core/walk.py``), 3 more under ``torch.profiler``; every teacher
   parameter and buffer must be bitwise unchanged and the losses finite.
   Then the plain CRW flagship step on the default route in the same
   process, for comparison.
14. A small f32 teacher-student step card vs CPU (same weights, clips and
   masks: loss, q, student gradients, the card's launches), and one small
   ``sk_targets`` CRW loss card vs CPU.
15. Drives the trainer's loop (``cli/train.py``: ``train_args``,
   ``build`` with its threaded loader and its prefetcher to the card,
   ``train_one_epoch`` with the device augmentations and the host's
   patch/superpixel draw) over in-memory clips (seeded low-frequency
   textures in motion, 288 px uint8, ``Kinetics400``'s item contract), in
   three arms, each an epoch of 3 warm-up steps and a timed epoch with
   every kernel count zeroed just before and read just after: (a)
   ``train.sh``'s config of record (prob 0.7, SLIC 36, 44 node slots, L1
   dilation k=55; 20 timed steps, both paths), then one ``--resume`` step
   through ``main`` from the ``checkpoint.pth`` it wrote; (b) the flagship
   patch loop; (c) teacher-student at (b)'s shape from a seeded teacher
   written by ``save_checkpoint`` (#4 x15 a step, the teacher bitwise
   unchanged). Each gives ms a step by the host clock and by path (CUDA
   events) beside the bare step of its config run in this process.
16. The encoder variants (``encoders``): the flagship step with the
   ``scratch50`` ResNet-50 trunk (default route: #5, #9, #10 15 times a
   step, #4 and #6-#8 never; 29.30 TFLOP a step; profiled), a small f32
   ``scratch50`` step card vs CPU, remat off, ``layer1`` and ``all`` on the
   flagship step (the first two losses and the BN statistics after the
   first step within 1e-6 of the off arm; #5 once more a step for each
   routed conv a rematerialized stage recomputes; step ms and peak
   memory), a seeded ResNet-50 under torchvision's key names written to a
   temporary ``.pth`` and loaded through ``--pretrained-path``
   (``imagenet50``) into ``cli.test.test()`` at the Eval config (layer4
   removed, C = 1024: #1 streams its query tile, once a target, held to
   its plain version on the eval's features), and #1 against its plain
   version on random and near-tie features at C = 1024 and 2048.
17. Superpixel training from host masks (``host_sp``): ``train.sh``'s flags
   with ``--sp-backend host --augs-backend host`` through the trainer's
   loop over views made once by the device transform (no file is read and
   no host augmentation runs: the host masks are this phase's subject) and
   ids made in the loader's threads by
   ``data/superpixels.py::host_sp_mask`` (native SLIC, and the per-clip
   SLIC/FH mix), beside the same flags with SLIC on the card: each
   superpixel step gets the loader's ids, #12 never launches and #11 once
   a step, #11 equals its plain version on those ids and on dense FH ids
   past the 44 slots; step ms (host clock, CUDA events), device busy and
   idle share, host ms a frame of SLIC and FH; then a ``--profile-dir``
   run whose trace of steps 5-9 must name the hand kernels (their device
   time printed beside this run's kernel line).
18. Multi-GPU on one card (``multi``; no scaling can show on one card):
   (a) ``cli.train --distributed`` at world size 1 over NCCL (``env://``)
   on the flagship patch loop, in turns with the plain loop: the first
   loss bitwise the plain loop's, the same launches, ms a step of each;
   (b) two gloo ranks sharing cuda:0 (NCCL takes one rank a device): the
   flagship patch step (global batch 8, 4 a rank) and train.sh's
   superpixel step (global batch 6, SLIC #12 with active counts drawn for
   the global batch, dilation #11), 3 SGD steps against one process on the
   global batch, each kernel's launches per rank; (c) #1 in tile-row bands
   at DAVIS-480p, C 512, 16 labels over ``[cuda:0] * D``, D 2, 3, 8:
   bitwise the unbanded propagation, ms a band; (d) the multi-process dry
   run (``videowalk_tpu_torch/parallel/dryrun.py``) at world 2.
19. The users' launch recipes from files (``files``), each run as a user
   runs it, in its own process: (a) a Kinetics-layout tree of 128 videos
   (8 classes, 100 frames of moving textures at 340x256, 25 fps) written
   by ``cv2.VideoWriter`` (mp4v, which the card's cv2 4.13.0 writes and
   reads) and read back by the port's reader; (b) ``bash train_torch.sh
   --epochs 2`` on it (train.sh's flags: cv2 decode and the host
   augmentations in the loader's threads, the metadata cache, SLIC #12 and
   dilation #11 on the card), every printed loss finite, ``checkpoint.pth``
   and the cache written, its ``--profile-dir`` trace of steps 5-9 holding
   exactly the launches of the paths drawn there; ms a step, the loader's
   wait (``data:``), device busy and idle share, start-up; then
   ``--resume`` to a third epoch, which must read the cache and continue at
   epoch 2; (c) ``bash test_torch.sh`` at that checkpoint on a DAVIS-2017
   tree of 854x480 JPEG frames and palette annotations (2 videos of 30
   frames, 3 and 2 moving squares): exit 0, a converted PNG a frame, a
   finite J&F, #1 once a target in the traced video; video0 cut to 8
   frames through the chain on the card and with ``--device cpu``: J&F
   within 1e-3, soft predictions within 1e-4 on >= 99.9% of label cells;
   (d) at the trained weights: #1 against its plain version on the eval's
   features (cells over 1e-4, queries whose top-k ids differ), the small
   f32 patch and superpixel steps card vs CPU with the checkpoint's weights
   and BN statistics, and how far those statistics and the walk loss moved.
   The kernel line gives each kernel these runs launched its
   ``files_launches`` (training steps 5-9, eval video 1).

Prints one JSON line of kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``. Any failed phase raises (non-zero exit,
no result). It needs a CUDA card and the repository around it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from videowalk_tpu_torch.cli.test import build_model, encode_video, test
from videowalk_tpu_torch.eval.propagation import context_index_bank
from videowalk_tpu_torch.core.masks import make_dilation_kernel
from videowalk_tpu_torch.data.superpixels import (compute_sp_FH,
                                                  compute_sp_slic,
                                                  host_sp_mask)
from videowalk_tpu_torch.data.jhmdb import (pose_label_buffer, pose_labels,
                                            pose_lblset)
from videowalk_tpu_torch.data.vos import IMAGENET_MEAN, IMAGENET_STD
from videowalk_tpu_torch.eval.davis_metrics import f_measure, jaccard
from videowalk_tpu_torch.eval.eval_pck import pck_scores
from videowalk_tpu_torch.eval.eval_vip import fast_hist, show_result
from videowalk_tpu_torch.eval.test_utils import process_pose
from videowalk_tpu_torch.models import CRW, CRWConfig, CRWTeacherStudent
from videowalk_tpu_torch.models.crw import superpixel_pool_weights
from videowalk_tpu_torch.models.resnet import remat_stage_set, resnet50
from videowalk_tpu_torch.ops import _build
from videowalk_tpu_torch.ops import bn_act as ba
from videowalk_tpu_torch.ops import prop_sparse as ps
from videowalk_tpu_torch.ops import rconv as rc
from videowalk_tpu_torch.ops import walk as wk
from videowalk_tpu_torch.ops.dilation import (choose_band, dilate_l1,
                                             dilate_l1_plain)
from videowalk_tpu_torch.ops.slic import device_launches, slic_fused
from videowalk_tpu_torch.ops.slic_device import (initial_centers, rgb_to_lab,
                                                 slic, slic_geometry)
from videowalk_tpu_torch.parallel import (create_train_state, make_optimizer,
                                          make_train_step)
from videowalk_tpu_torch.utils.checkpoint import partial_load

# DAVIS-480p eval geometry of the config of record
H, W, C, NL = 60, 107, 256, 4
N_CONTEXT, LONG_MEM, TOPK, RADIUS, TEMP = 20, [0], 10, 12.0, 0.05
FP32_PEAK = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
BF16_PEAK = 989e12       # H100 SXM dense bf16 FLOP/s (tensor cores)
TF32_PEAK = 495e12       # H100 SXM dense TF32 FLOP/s (tensor cores)
HBM_RATE = 3.35e12       # H100 SXM bytes/s
# the eval tail's other geometries (the DAVIS config's videoLen, topk,
# radius and T): JHMDB at cropSize 320 (40x40 maps, 15 joints +
# background; eval_pck.py's FEAT_RES) and VIP's 20 classes at 480x854
JHMDB_SIZE, JHMDB_JOINTS, VIP_CLASSES, TAIL_TARGETS = 320, 15, 20, 20
# bench.py's flagship training step
CLIP_LEN, N_PATCHES, PATCH, BATCH, WALK_TEMP, EDGEDROP = 8, 49, 64, 8, 0.05, 0.1
# the fused-walk gate's sweep: (T, N, C) at batch 8
WALK_SWEEP = dict(T=(4, 8, 10), N=(48, 49, 64, 96, 128), C=(128, 256, 512))
# reflect-conv kernels at the step's shapes: (tag, N, Cin, Cout, H, W)
RCONV_SHAPES = (("flagship", 3136, 512, 512, 8, 8),     # layer4 interior
                ("layer1", 3136, 64, 64, 16, 16),
                ("cin_ne_cout", 3136, 128, 256, 8, 8),  # layer3.0.conv1
                ("32x32", 196, 512, 512, 32, 32),       # the same pixels
                # the superpixel step of record: layer4's interiors on the
                # 24 whole frames' 32x32 maps, and its patch arm's 6x4x49 patches
                ("sp", 24, 512, 512, 32, 32),
                ("patch6x4", 1176, 512, 512, 8, 8))
# #5's moments against the f32 sums of a y, per channel: s1 within MOM_TOL
# of that channel's sum |y|, s2 within MOM_TOL of its sum y^2. "own": the
# kernel's own cast y (the same values summed in another order); "ref": the
# plain version's y (whose bf16 roundings may differ from the kernel's)
MOM_TOL = dict(own=1e-5, ref=2e-5)
# #7's da and db against f32 sums of the plain f32 dxn, per channel,
# relative to that channel's sum |dxn*g*x| and sum |dxn*g|: the kernel
# rounds each boundary pixel's summed gy legs to bf16 (2^-9 relative on ~40%
# of an 8x8 map's pixels, signs random, 2e5 pixels a channel), the plain
# version does not: the largest reading at the four shapes is 3.7e-5
DAB_TOL = 2e-4
# #6's moments on a ragged last tile (3 images of 8x8: 192 pixels a
# channel) against the plain y, per channel: where the two sides round a y
# entry to bf16 differently its channel's sums move by up to 2^-8 of that
# entry, ~1e-4 of a 192-row channel's sum |y| (the card tests' bound)
RAGGED_MOM_TOL = 1e-3
RCONV = (("fwd", rc.reflect_conv_fwd), ("fwd_stats", rc.reflect_conv_fwd_stats),
         ("dx", rc.reflect_conv_dx), ("dw", rc.reflect_conv_dw),
         ("fwd_bnin_stats", rc.reflect_conv_fwd_bnin_stats),
         ("dx_bnin", rc.reflect_conv_dx_bnin),
         ("dw_bnin", rc.reflect_conv_dw_bnin))
BN = (("bn_moments", ba.bn_moments), ("bn_act_fwd", ba.bn_act_fwd),
      ("bn_act_reduce_bwd", ba.bn_act_reduce_bwd),
      ("bn_act_apply_bwd", ba.bn_act_apply_bwd), ("bn_fold", ba.bn_fold))
# the BN passes every train-mode trunk runs each step (the stem's BN
# reduces its own moments, takes the ReLU and its backward)
BN_EVERY_STEP = ("bn_moments", "bn_act_fwd", "bn_act_reduce_bwd",
                 "bn_act_apply_bwd")
DEFAULT_ARM = ("auto", "auto")
# the superpixel step of record (the reference's train.sh): batch 6, clips of
# 4 whole 256 px frames, SLIC with 36 segments and compactness 50 inside the
# step, 48 node slots, L1 dilation k=55
SP_BATCH, SP_CLIP, SP_IMG, NUM_SP, COMPACTNESS, MAX_SP, DIL_K = \
    6, 4, 256, 36, 50.0, 48, 55
SLIC_ITERS = 10
# f32 operations of one (pixel, center in its window) pair of a SLIC
# assignment: 5 subtractions, 5 multiplications, 4 additions; a center
# update adds 5 sums and a count a pixel
SLIC_PAIR_FLOPS, SLIC_UPDATE_FLOPS = 14, 6


def _launches(fwd=0, fwd_stats=0, dx=0, dw=0, bnin=0) -> dict:
    return dict(fwd=fwd, fwd_stats=fwd_stats, dx=dx, dw=dw,
                fwd_bnin_stats=bnin, dx_bnin=bnin, dw_bnin=bnin)


# training arms: (rconv, bn_fuse) -> reflect-conv launches per step.
# 'auto' (the H100's set, PERF.md section 5) and 'on' route every 3x3
# stride-1 conv of the blocks (15: all but layer2.0.conv1); under bn_fuse
# 'auto' the 8 conv2 take the chain and the 7 others #5; without the fold
# ('off') the 15 take #4. 'on' is 'auto' today, so each bn_fuse runs once.
ARMS = ((("off", "stats"), _launches()),
        (("auto", "stats"), _launches(fwd_stats=15, dx=15, dw=15)),
        (("auto", "auto"), _launches(fwd_stats=7, dx=7, dw=7, bnin=8)),
        (("on", "off"), _launches(fwd=15, dx=15, dw=15)))


# the teacher-student step (alpha 0.5): the teacher's eval-mode trunk takes
# #4 on the 15 routed convs; the student's train-mode trunk the default
# route's kernels; its plain-softmax walk takes core/walk.py (no walk kernel)
TS_ALPHA = 0.5
TS_LAUNCHES = _launches(fwd=15, fwd_stats=7, dx=7, dw=7, bnin=8)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def lowfreq_features(rng: np.random.RandomState, h: int, w: int, c: int,
                     cell: int = 8) -> np.ndarray:
    """A low-frequency random field ``(h, w, c)``: a coarse grid of uniform
    values, one a ``cell`` cells, interpolated bilinearly (what
    ``tools/sweep_synth_davis.py``'s ``lowfreq_texture`` makes for pixels,
    here for feature channels, in numpy alone)."""
    base = rng.rand(h // cell + 2, w // cell + 2, c).astype(np.float32) - 0.5
    ys, xs = np.arange(h) / cell, np.arange(w) / cell
    y0, x0 = ys.astype(int), xs.astype(int)
    fy = (ys - y0).astype(np.float32)[:, None, None]
    fx = (xs - x0).astype(np.float32)[None, :, None]
    return np.ascontiguousarray(
        (base[y0][:, x0] * (1 - fx) + base[y0][:, x0 + 1] * fx) * (1 - fy)
        + (base[y0 + 1][:, x0] * (1 - fx) + base[y0 + 1][:, x0 + 1] * fx) * fy)


def prop_inputs(kind: str, n_targets: int, c: int = C):
    """Features ``(N, H, W, c)`` (unit rows) and the label buffer ``(N, H,
    W, NL)`` with frames 0..N_CONTEXT given. ``random``: independent unit
    vectors and one-hot labels of random cells (near-ties rare). ``near_tie``:
    every frame a copy of one smooth texture rolled by one cell every two
    frames (the DAVIS objects ride the roll), plus noise of 1e-7 a
    channel, so a query's copies in its context frames tie to within ~1e-5
    in logit; the labels are one-hot regions of a smooth field that ride the
    same roll."""
    rng = np.random.RandomState(0)
    N = N_CONTEXT + n_targets
    lab = np.zeros((N, H, W, NL), np.float32)
    if kind == "random":
        f = rng.randn(N, H, W, c).astype(np.float32)
        lab[:N_CONTEXT + 1] = np.eye(NL, dtype=np.float32)[
            rng.randint(0, NL, (H, W))]
    else:
        tex = lowfreq_features(rng, H, W, c)
        regions = np.eye(NL, dtype=np.float32)[
            lowfreq_features(rng, H, W, NL).argmax(-1)]
        f = np.stack([np.roll(tex, t // 2, axis=1) for t in range(N)])
        f += 1e-7 * rng.randn(*f.shape).astype(np.float32)
        lab[:N_CONTEXT + 1] = np.stack(
            [np.roll(regions, t // 2, axis=1) for t in range(N_CONTEXT + 1)])
    f = np.ascontiguousarray(f / np.linalg.norm(f, axis=-1, keepdims=True))
    return torch.from_numpy(f).cuda(), torch.from_numpy(lab).cuda()


def topk_set_differs(feats, rows, kw) -> float:
    """The share of queries whose kept top-k ids differ between the kernel
    and the plain version, on the same features: each target once, with
    every (frame, cell) labelled one-hot by its id modulo 128 and then 127,
    so a different id set moves the prediction of the buckets of the ids
    swapped by their weights (the kept ids' weights are equal only up to
    the logits' rounding). A query counts where either probe differs by
    more than 1e-5."""
    N, HW = feats.shape[0], H * W
    cand = torch.arange(N * HW, device="cuda")
    differs = torch.zeros((len(rows), HW), dtype=torch.bool, device="cuda")
    for mod in (128, 127):
        buf = torch.nn.functional.one_hot(cand % mod, mod).float().reshape(
            N, H, W, mod)
        for i in range(len(rows)):
            t = int(rows[i, -1]) + 1
            idx = torch.from_numpy(rows[i]).cuda()
            got = ps.prop_sparse(feats, buf, idx, t, **kw)
            want = ps.prop_sparse_plain(feats, buf, idx, t, **kw)
            differs[i] |= (got - want).abs().amax(-1) > 1e-5
        del buf
    return float(differs.float().mean())


def kernel_vs_plain(n_targets: int = 4, c: int = C) -> dict:
    """Phase 2: kernel and plain version target by target on one shared
    label buffer (each target's kernel prediction written back, as the
    eval writes it), on the random and the near-tie feature sets of ``c``
    channels; the share of queries whose top-k ids differ; times on the
    random set."""
    rows = context_index_bank(N_CONTEXT, LONG_MEM, n_targets)
    kw = dict(n_long=len(LONG_MEM), topk=TOPK, temperature=TEMP,
              radius=RADIUS)
    for cc, k, r in ((C, TOPK, RADIUS), (512, 32, RADIUS), (576, 10, RADIUS),
                     (608, 10, RADIUS), (1024, TOPK, RADIUS),
                     (2048, 32, RADIUS), (20, 32, 12.5), (256, 10, 40.0)):
        src = int(ps._lib().prop_sparse_smem_bytes(cc, k, ps.sparse_halo(r)))
        if src != ps.smem_bytes(cc, k, r):
            fail(f"prop_sparse.smem_bytes({cc}, {k}, {r}) = "
                 f"{ps.smem_bytes(cc, k, r)}, the source's {src}")
    res = dict(channels=c, query_tile=(
        "streamed" if ps.streams_query(c, TOPK, RADIUS) else "resident"))
    for kind in ("random", "near_tie"):
        feats, buf = prop_inputs(kind, n_targets, c)
        errs = []
        for i in range(n_targets):
            t = int(rows[i, -1]) + 1
            idx = torch.from_numpy(rows[i]).cuda()
            got = ps.prop_sparse(feats, buf, idx, t, **kw)
            want = ps.prop_sparse_plain(feats, buf, idx, t, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"kernel output not finite at target {i} ({kind})")
            errs.append((got - want).abs().max(-1).values.cpu().numpy())
            buf[t] = got.view(H, W, NL)     # both read the same buffer next
        err = np.concatenate(errs)
        r = dict(max_abs_err=float(err.max()), mean_abs_err=float(err.mean()),
                 frac_over_1e4=float((err > 1e-4).mean()),
                 topk_differs=topk_set_differs(feats, rows, kw))
        print(f"prop_sparse vs plain at DAVIS-480p, C={c} ({res['query_tile']} "
              f"query tile), {kind} features "
              f"({n_targets} targets, autoregressive): max|d| "
              f"{r['max_abs_err']:.3e} mean|d| {r['mean_abs_err']:.3e} cells "
              f"|d|>1e-4 {r['frac_over_1e4']:.5f} (tolerance: |d| <= 1e-4 on "
              f">= 99.9% of cells); queries whose top-k ids differ "
              f"{r['topk_differs']:.5f}", flush=True)
        if r["frac_over_1e4"] > 1e-3:
            fail(f"kernel disagrees with its plain version on more than 0.1% "
                 f"of cells by more than 1e-4 ({kind} features, C={c})")
        if kind == "random":
            idx = torch.from_numpy(rows[-1]).cuda()
            t_last = int(rows[-1, -1]) + 1
            r["ms"] = cuda_ms(
                lambda: ps.prop_sparse(feats, buf, idx, t_last, **kw), 20)
            r["plain_ms"] = cuda_ms(lambda: ps.prop_sparse_plain(
                feats, buf, idx, t_last, **kw), 3, 1)
            print(f"prop_sparse {r['ms']:.3f} ms/target (median of 20), "
                  f"plain {r['plain_ms']:.3f} ms/target at C={c}", flush=True)
        res[kind] = r
        del feats, buf
    L = rows.shape[1]
    pairs = ps.valid_pairs(H, W, RADIUS, len(LONG_MEM), L - len(LONG_MEM))
    scored = scored_pairs(L)
    flops = 2.0 * c * pairs
    nbytes = 4.0 * ((L + 1) * H * W * c + L * H * W * NL + H * W * NL) + 4 * L
    res.update(res.pop("random"))
    res.update(pairs=pairs, scored_pairs=scored, gflop=flops / 1e9,
               ops_ms=flops / FP32_PEAK * 1e3,
               tf32_ms=3 * flops / TF32_PEAK * 1e3,
               bytes_ms=nbytes / HBM_RATE * 1e3)
    res["bound_ms"] = max(res["ops_ms"], res["bytes_ms"])
    res["bound_by"] = "operations" if res["ops_ms"] >= res["bytes_ms"] \
        else "bytes"
    print(f"prop_sparse bound at C={c} {res['bound_ms']:.3f} ms "
          f"({res['gflop']:.1f} GFLOP f32 over {pairs} valid pairs; "
          f"{res['tf32_ms']:.3f} ms for the same as 3xTF32 on the tensor "
          f"cores); "
          f"{scored / (H * W):.0f} candidates scored a query, "
          f"{pairs / (H * W):.0f} valid", flush=True)
    return res


def scored_pairs(L: int) -> int:
    """(query, candidate) pairs the kernel scores for one target: per 8x8
    tile, its 64 query slots against every cell of the long frames and, in
    each short frame, the tile's disk union cut to the frame."""
    off = ps.disk_union_offsets(RADIUS)
    n_long = len(LONG_MEM)
    total = 0
    for ty in range(0, H, ps.TQ):
        for tx in range(0, W, ps.TQ):
            y, x = off[:, 0] + ty, off[:, 1] + tx
            inside = int(((y >= 0) & (y < H) & (x >= 0) & (x < W)).sum())
            total += ps.TQ * ps.TQ * (n_long * H * W + (L - n_long) * inside)
    return total


def synthetic_video(n_frames: int, h: int, w: int, seed: int,
                    return_ids: bool = False):
    """Moving squares on a noisy background: uint8 frames (with the
    videoLen prefix of frame-0 copies) and one-hot labels (background + 2
    objects) at feature resolution (8x8 area average); with ``return_ids``
    the frames and each frame's per-pixel object ids ``(n_frames, h, w)``
    instead."""
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 90, (h, w, 3)).astype(np.uint8)
    s = max(h // 5, 4)
    imgs, ids = [], []
    for t in range(n_frames):
        img, lbl = bg.copy(), np.zeros((h, w), np.int64)
        for k, (y0, x0, vy, vx, col) in enumerate(
                ((h // 5, w // 8, 1, 3, (220, 40, 40)),
                 (h // 2, w // 2, -1, -2, (40, 200, 60)))):
            y = int(np.clip(y0 + vy * t * h // 120, 0, h - s))
            x = int(np.clip(x0 + vx * t * w // 240, 0, w - s))
            img[y:y + s, x:x + s] = col
            lbl[y:y + s, x:x + s] = k + 1
        imgs.append(img)
        ids.append(lbl)
    imgs = np.stack([imgs[0]] * N_CONTEXT + imgs)
    if return_ids:
        return imgs, np.stack(ids)
    onehot = np.eye(3, dtype=np.float32)[np.stack([ids[0]] * N_CONTEXT + ids)]
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    onehot = np.pad(onehot, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)),
                    mode="edge")
    lbls = onehot.reshape(len(onehot), hp // 8, 8, wp // 8, 8, 3).mean((2, 4))
    lblset = np.array([[0, 0, 0], [128, 0, 0], [0, 128, 0]], np.uint8)
    return imgs, lbls.astype(np.float32), lblset


def eval_args() -> types.SimpleNamespace:
    return types.SimpleNamespace(
        model_type="scratch", remove_layers=["layer4"], head_depth=-1,
        videoLen=N_CONTEXT, long_mem=LONG_MEM, topk=TOPK, radius=RADIUS,
        temperature=TEMP, no_l2=False, norm_mask=False, save_path="")


def run_eval(model, imgs, lbls, lblset):
    preds = {}

    def keep(pred, lbl_map, img, prefix, **kw):
        preds[int(prefix.rsplit("_", 1)[1])] = pred

    stats = test([(imgs, imgs, lbls, None, lblset, {})], model, eval_args(),
                 dump=keep)
    return [preds[t] for t in range(len(preds))], stats[0]


def end_to_end(n_targets: int) -> dict:
    """Phase 3: the eval slice at 480x854 on the card."""
    dev = torch.device("cuda")
    model = build_model(eval_args(), dev, seed=0)
    imgs, lbls, lblset = synthetic_video(n_targets, 480, 854, seed=1)
    run_eval(model, imgs[:N_CONTEXT + 2], lbls[:N_CONTEXT + 2], lblset)  # warm
    torch.cuda.synchronize()
    ps.prop_sparse.launches = 0                      # counts: main path only
    preds, st = run_eval(model, imgs, lbls, lblset)
    launches = ps.prop_sparse.launches
    if len(preds) != n_targets or launches != n_targets:
        fail(f"{len(preds)} predictions, {launches} kernel launches for "
             f"{n_targets} targets")
    for p in preds:
        if p.shape != (H, W, 3) or not np.isfinite(p).all():
            fail(f"bad prediction: shape {p.shape}, finite "
                 f"{np.isfinite(p).all()}")
    if not np.array_equal(preds[0], lbls[0]):
        fail("first target is not the frame-0 ground truth")
    # how far the masks track the squares (random weights: informative only)
    acc = float(np.mean([(p.argmax(-1) == l.argmax(-1)).mean()
                         for p, l in zip(preds, lbls[N_CONTEXT:])]))
    res = dict(frames=st["frames"], targets=st["targets"], launches=launches,
               encode_ms_per_frame=st["encode_s"] * 1e3 / st["frames"],
               prop_ms_per_target=st["propagate_s"] * 1e3 / st["targets"],
               e2e_ms_per_frame=st["total_s"] * 1e3 / st["targets"],
               label_acc=acc)
    print(f"eval slice 480x854, {st['frames']} frames ({n_targets} targets): "
          f"encode {res['encode_ms_per_frame']:.2f} ms/frame, propagation "
          f"{res['prop_ms_per_target']:.2f} ms/target, end to end "
          f"{res['e2e_ms_per_frame']:.2f} ms/frame; launches {launches}; "
          f"label agreement with the squares {acc:.3f}", flush=True)
    return res


def small_card_vs_cpu() -> dict:
    """Phase 4: the whole slice on a small video, card vs CPU path (the
    plain version), same weights. Tolerance 1e-4: f32 encoders by different
    conv algorithms, then f32 propagation."""
    cuda_model = build_model(eval_args(), torch.device("cuda"), seed=2)
    cpu_model = build_model(eval_args(), torch.device("cpu"), seed=2)
    imgs, lbls, lblset = synthetic_video(8, 64, 96, seed=3)
    feats_gpu = encode_video(cuda_model, imgs[:2]).cpu()
    feats_cpu = encode_video(cpu_model, imgs[:2])
    enc_err = float((feats_gpu - feats_cpu).abs().max())
    before = ps.prop_sparse.launches
    got, _ = run_eval(cuda_model, imgs, lbls, lblset)
    want, _ = run_eval(cpu_model, imgs, lbls, lblset)
    ps.prop_sparse.launches = before     # comparison launches do not count
    err = float(max(np.abs(g - w).max() for g, w in zip(got, want)))
    print(f"small video 64x96, card vs CPU: encoder max|d| {enc_err:.3e}, "
          f"predictions max|d| {err:.3e} (tolerance 1e-4)", flush=True)
    if not err <= 1e-4:
        fail("card and CPU paths disagree on the small video")
    return dict(encoder_max_abs_err=enc_err, pred_max_abs_err=err)


def moving_squares(n_frames: int, h: int, w: int, n_obj: int, seed: int):
    """``n_obj`` seeded colored squares moving at constant speeds over a
    noisy background: uint8 frames ``(n_frames, h, w, 3)``, per-pixel ids
    ``(n_frames, h, w)`` (0 the background, square j id j + 1, later squares
    on top) and the squares' centres ``(n_frames, n_obj, 2)`` as (x, y)."""
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 90, (h, w, 3)).astype(np.uint8)
    s = max(min(h, w) // 12, 8)
    cols = rng.randint(60, 256, (n_obj, 3)).astype(np.uint8)
    lim = np.array([w - s, h - s])
    p0 = rng.rand(n_obj, 2) * lim
    v = (rng.rand(n_obj, 2) - 0.5) * np.array([w, h]) / 60
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    ids = np.zeros((n_frames, h, w), np.int64)
    centres = np.zeros((n_frames, n_obj, 2))
    for t in range(n_frames):
        frames[t] = bg
        pos = np.clip(p0 + v * t, 0, lim).astype(int)
        for j, (x, y) in enumerate(pos):
            frames[t, y:y + s, x:x + s] = cols[j]
            ids[t, y:y + s, x:x + s] = j + 1
        centres[t] = pos + (s - 1) / 2
    return frames, ids, centres


def area_labels(ids: np.ndarray, n_cls: int) -> np.ndarray:
    """``(T, ceil(h/8), ceil(w/8), n_cls)`` f32 one-hot labels at feature
    resolution (8x8 area average of the edge-padded ids), frame by
    frame."""
    out = []
    for f in ids:
        hp, wp = -(-f.shape[0] // 8) * 8, -(-f.shape[1] // 8) * 8
        f = np.pad(f, ((0, hp - f.shape[0]), (0, wp - f.shape[1])),
                   mode="edge")
        oh = np.eye(n_cls, dtype=np.float32)[f]
        out.append(oh.reshape(hp // 8, 8, wp // 8, 8, n_cls).mean((1, 3)))
    return np.stack(out)


def pixel_ids(preds, h: int, w: int) -> np.ndarray:
    """Per-pixel ids ``(T, h, w)``: each soft label map ``(h', w', L)``
    upsampled bilinearly to ``(h, w)`` on the card, then its argmax (the
    file path's cv2 resize, without cv2)."""
    out = []
    for p in preds:
        x = torch.from_numpy(np.ascontiguousarray(p)).cuda().permute(2, 0, 1)
        up = torch.nn.functional.interpolate(x[None], size=(h, w),
                                             mode="bilinear",
                                             align_corners=False)
        out.append(up[0].argmax(0))
    return torch.stack(out).cpu().numpy()


def tail_eval(model, imgs, imgs_orig, lbls, lblset, filelist: str,
              save_path: str, img_paths=None) -> tuple[list, dict, int]:
    """One video through ``cli.test.test()`` as the file path drives it
    (``filelist`` picks the JHMDB keypoints or the VIP output layout;
    ``save_path`` takes the keypoints and VIP's directories), with #1's
    count zeroed just before and read just after: the predictions in
    target order, the video's stats, the launches."""
    preds = {}

    def keep(pred, lbl_map, img, prefix, **kw):
        preds[prefix] = pred

    args = eval_args()
    args.filelist = filelist
    args.save_path = save_path
    meta = dict(img_paths=img_paths) if img_paths else {}
    torch.cuda.synchronize()
    ps.prop_sparse.launches = 0
    stats = test([(imgs, imgs_orig, lbls, lbls, lblset, meta)], model, args,
                 dump=keep)
    launches = ps.prop_sparse.launches
    # prefixes end in "{vid}_{t}", or in "{t:06d}.jpg" under videos/
    order = sorted(preds, key=lambda k: int(
        os.path.basename(k).split(".")[0].split("_")[-1]))
    return [preds[k] for k in order], stats[0], launches


def prop_against_plain(model, imgs, lbls, n_targets: int, tag: str) -> dict:
    """#1 against its plain version target by target on the eval's own
    features and label buffer (the kernel's prediction written back, as
    the eval writes it): |d| <= 1e-4 on >= 99.9% of label cells (a cell's
    largest difference over its labels). These launches do not count."""
    before = ps.prop_sparse.launches
    feats = encode_video(model, imgs).permute(0, 2, 3, 1).contiguous()
    buf = torch.from_numpy(np.ascontiguousarray(lbls)).cuda()
    rows = context_index_bank(N_CONTEXT, LONG_MEM, n_targets)
    kw = dict(n_long=len(LONG_MEM), topk=TOPK, temperature=TEMP,
              radius=RADIUS)
    errs = []
    for i in range(n_targets):
        t = int(rows[i, -1]) + 1
        idx = torch.from_numpy(rows[i]).cuda()
        got = ps.prop_sparse(feats, buf, idx, t, **kw)
        want = ps.prop_sparse_plain(feats, buf, idx, t, **kw)
        if not torch.isfinite(got).all():
            fail(f"kernel output not finite at target {i} ({tag})")
        errs.append((got - want).abs().amax(-1).cpu().numpy())
        buf[t] = got.view(buf.shape[1:])
    ps.prop_sparse.launches = before
    err = np.concatenate(errs)
    r = dict(max_abs_err=float(err.max()),
             frac_over_1e4=float((err > 1e-4).mean()))
    print(f"prop_sparse vs plain at {tag} ({buf.shape[-1]} labels, "
          f"{tuple(buf.shape[1:3])} maps, {n_targets} targets): max|d| "
          f"{r['max_abs_err']:.3e}, cells |d|>1e-4 {r['frac_over_1e4']:.5f} "
          f"(tolerance: |d| <= 1e-4 on >= 99.9% of cells)", flush=True)
    if r["frac_over_1e4"] > 1e-3:
        fail(f"kernel disagrees with its plain version at {tag}")
    return r


def davis_tail(model, n_targets: int, h: int = 480, w: int = 854) -> dict:
    """The DAVIS J&F chain in memory: the eval phase's video through
    ``test()``, per-pixel ids from its predictions, J and F per object over
    frames 1..N-2 with the port's array core; ground truth scored against
    itself must give J = F = 1 exactly."""
    imgs, lbls, lblset = synthetic_video(n_targets, h, w, seed=1)
    _, gt = synthetic_video(n_targets, h, w, seed=1, return_ids=True)
    run_eval(model, imgs[:N_CONTEXT + 2], lbls[:N_CONTEXT + 2], lblset)  # warm
    torch.cuda.synchronize()
    ps.prop_sparse.launches = 0
    preds, st = run_eval(model, imgs, lbls, lblset)
    if ps.prop_sparse.launches != n_targets:
        fail(f"DAVIS tail: {ps.prop_sparse.launches} launches for "
             f"{n_targets} targets")
    t0 = time.perf_counter()
    pred = pixel_ids(preds, h, w)
    t1 = time.perf_counter()
    js, fs = {1: [], 2: []}, {1: [], 2: []}
    for t in range(1, n_targets - 1):
        for o in js:
            js[o].append(jaccard(pred[t] == o, gt[t] == o))
            fs[o].append(f_measure(pred[t] == o, gt[t] == o))
    t2 = time.perf_counter()
    for t in range(n_targets):
        for o in js:
            if (jaccard(gt[t] == o, gt[t] == o) != 1.0
                    or f_measure(gt[t] == o, gt[t] == o) != 1.0):
                fail(f"ground truth against itself: J or F is not 1 "
                     f"(frame {t}, object {o})")
    J = float(np.mean([np.mean(v) for v in js.values()]))
    F = float(np.mean([np.mean(v) for v in fs.values()]))
    n = n_targets - 2
    r = dict(J=J, F=F, JF=(J + F) / 2, targets=n_targets, launches=n_targets,
             prop_ms_per_target=st["propagate_s"] * 1e3 / st["targets"],
             upsample_ms_per_frame=(t1 - t0) * 1e3 / n_targets,
             metric_ms_per_frame=(t2 - t1) * 1e3 / n)
    print(f"DAVIS tail {h}x{w}, {n_targets} targets: J {J:.4f} F {F:.4f} "
          f"J&F {r['JF']:.4f} (random weights: informative only; ground "
          f"truth against itself J = F = 1); propagation "
          f"{r['prop_ms_per_target']:.2f} ms/target, upsample + argmax "
          f"{r['upsample_ms_per_frame']:.2f} ms/frame, J and F (2 objects) "
          f"{r['metric_ms_per_frame']:.2f} ms/frame on the host",
          flush=True)
    return r


def jhmdb_tail(model, n_targets: int, out: str, n: int = JHMDB_SIZE
               ) -> dict:
    """JHMDB's eval geometry: 320x320 frames (cropSize 320, 40x40 maps) of
    15 moving squares, their centres the joints, drawn as
    ``draw_labelmap_np`` heatmaps behind a background channel (16 labels),
    normalized float frames as ``JhmdbSet`` gives them; through ``test()``
    (keypoints by ``process_pose``), then the PCK core."""
    frames, _, centres = moving_squares(n_targets, n, n, JHMDB_JOINTS, 4)
    gt = centres.transpose(2, 1, 0)                  # (2, J, T), 0-indexed
    lbls = pose_label_buffer(pose_labels(gt / 8.0, n // 8, n // 8, 0.5),
                             N_CONTEXT)
    orig = np.concatenate([frames[:1]] * N_CONTEXT + [frames]).astype(
        np.float32) / 255.0
    imgs = ((orig - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))
    lblset = pose_lblset(JHMDB_JOINTS)
    preds, st, launches = tail_eval(model, imgs, orig, lbls, lblset,
                                    "jhmdb_synthetic", out)
    if launches != n_targets or len(preds) != n_targets:
        fail(f"JHMDB tail: {launches} launches, {len(preds)} predictions "
             f"for {n_targets} targets")
    kp = st["keypoints"]
    if kp.shape != (2, JHMDB_JOINTS, n_targets) or not np.isfinite(kp).all():
        fail(f"JHMDB tail: keypoints {kp.shape}")
    t0 = time.perf_counter()
    for p in preds:
        process_pose(p, lblset)
    t1 = time.perf_counter()
    pck = pck_scores([gt], [kp], [(n, n)], feat_res=(n // 8, n // 8))
    t2 = time.perf_counter()
    vals = [pck[t] for t in sorted(pck)]
    if not all(0.0 <= v <= 100.0 for v in vals) or vals != sorted(vals):
        fail(f"JHMDB tail: PCK {pck}")
    r = dict(pck={str(k): v for k, v in pck.items()}, launches=launches,
             prop_ms_per_target=st["propagate_s"] * 1e3 / n_targets,
             encode_ms_per_frame=st["encode_s"] * 1e3 / st["frames"],
             pose_ms_per_target=(t1 - t0) * 1e3 / n_targets,
             pck_ms_per_target=(t2 - t1) * 1e3 / n_targets,
             vs_plain=prop_against_plain(model, imgs, lbls, n_targets,
                                         f"JHMDB {n}x{n}"))
    print(f"JHMDB tail {n}x{n} ({n // 8}x{n // 8} maps, 16 labels), {n_targets} targets: "
          f"PCK@0.1-0.5 " + " ".join(f"{v:.1f}" for v in vals)
          + f" (random weights: informative only); launches {launches}; "
          f"propagation {r['prop_ms_per_target']:.3f} ms/target, encode "
          f"{r['encode_ms_per_frame']:.3f} ms/frame; process_pose "
          f"{r['pose_ms_per_target']:.3f}, PCK {r['pck_ms_per_target']:.3f} "
          f"ms/target on the host", flush=True)
    return r


def vip_tail(model, n_targets: int, out: str, h: int = 480, w: int = 854
             ) -> dict:
    """VIP's label width: 19 moving squares and the background (20
    classes) at 480x854 (the repository fixes no VIP crop: the DAVIS
    frame size), through ``test()`` on a ``VIP`` filelist (its
    ``videos/`` output layout), then ``fast_hist`` and ``show_result`` on
    per-pixel ids."""
    frames, ids, _ = moving_squares(n_targets, h, w, VIP_CLASSES - 1, 5)
    lbls = area_labels(np.concatenate([ids[:1]] * N_CONTEXT + [ids]),
                       VIP_CLASSES)
    imgs = np.concatenate([frames[:1]] * N_CONTEXT + [frames])
    paths = [f"VIP/videos/v0/{max(i - N_CONTEXT, 0):06d}.jpg"
             for i in range(len(imgs))]
    lblset = np.arange(VIP_CLASSES, dtype=np.uint8)[:, None]
    preds, st, launches = tail_eval(model, imgs, imgs, lbls, lblset,
                                    "VIP_synthetic", out, paths)
    if launches != n_targets or len(preds) != n_targets:
        fail(f"VIP tail: {launches} launches, {len(preds)} predictions for "
             f"{n_targets} targets")
    t0 = time.perf_counter()
    pred = pixel_ids(preds, h, w)
    t1 = time.perf_counter()
    hist = np.zeros((VIP_CLASSES, VIP_CLASSES))
    for t in range(n_targets):
        hist += fast_hist(ids[t], pred[t], VIP_CLASSES)
    res = show_result(hist)
    t2 = time.perf_counter()
    if not 0.0 <= res["mIoU"] <= 1.0 or hist.sum() != n_targets * h * w:
        fail(f"VIP tail: {res}, {hist.sum()} pixels")
    r = dict(res, launches=launches,
             prop_ms_per_target=st["propagate_s"] * 1e3 / n_targets,
             upsample_ms_per_target=(t1 - t0) * 1e3 / n_targets,
             metric_ms_per_target=(t2 - t1) * 1e3 / n_targets,
             vs_plain=prop_against_plain(model, imgs, lbls, n_targets,
                                         f"VIP {h}x{w}"))
    print(f"VIP tail {h}x{w} ({lbls.shape[1]}x{lbls.shape[2]} maps, 20 labels), {n_targets} targets: "
          f"mIoU {res['mIoU']:.4f} overall acc {res['overall_acc']:.4f} "
          f"(random weights: informative only); launches {launches}; "
          f"propagation {r['prop_ms_per_target']:.3f} ms/target; upsample "
          f"+ argmax {r['upsample_ms_per_target']:.2f}, fast_hist + "
          f"show_result {r['metric_ms_per_target']:.2f} ms/target on the "
          f"host", flush=True)
    return r


def bf16_encode(n_frames: int = 10, h: int = 480, w: int = 854) -> dict:
    """``--encode-dtype bfloat16`` against f32 on the DAVIS frames: the
    same seeded weights, a bf16 trunk, f32 features. Fails if a frame's
    cosine to the f32 features is 0.99 or less (the bound the JAX package
    holds its bf16 eval to)."""
    imgs, _ = synthetic_video(n_frames, h, w, seed=1, return_ids=True)
    frames = imgs[N_CONTEXT:]
    res, feats = {}, {}
    for dt in ("float32", "bfloat16"):
        args = eval_args()
        args.encode_dtype = dt
        model = build_model(args, torch.device("cuda"), seed=0)
        feats[dt] = encode_video(model, frames)
        if feats[dt].dtype != torch.float32:
            fail(f"--encode-dtype {dt}: features are {feats[dt].dtype}")
        res[f"{dt}_ms_per_frame"] = cuda_ms(
            lambda: encode_video(model, frames), 3, 1) / n_frames
        del model
    a = feats["bfloat16"].reshape(n_frames, -1).double()
    b = feats["float32"].reshape(n_frames, -1).double()
    cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-12)
    res.update(rel_l2=float((a - b).norm() / b.norm()),
               min_cosine=float(cos.min()))
    print(f"--encode-dtype bfloat16 vs float32 at {h}x{w} ({n_frames} "
          f"frames): rel L2 {res['rel_l2']:.3e}, smallest per-frame cosine "
          f"{res['min_cosine']:.6f} (bound > 0.99); encode "
          f"{res['bfloat16_ms_per_frame']:.3f} ms/frame bf16, "
          f"{res['float32_ms_per_frame']:.3f} f32", flush=True)
    if not res["min_cosine"] > 0.99:
        fail("bf16 encode: a frame's cosine to f32 is 0.99 or less")
    return res


def eval_tail_phase(card: str, n_targets: int = TAIL_TARGETS) -> dict:
    """The rest of the eval path on the card, in memory (``files`` runs
    the DAVIS chain from files): the DAVIS J&F chain, JHMDB PCK at
    its eval geometry (16 labels), VIP mIoU at its label width (20), #1
    launched once a target and held to its plain version at both widths,
    and ``--encode-dtype bfloat16`` against f32."""
    model = build_model(eval_args(), torch.device("cuda"), seed=0)
    # the JHMDB keypoints and VIP's directories go to a scratch directory
    # inside the checkout, removed after
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as out:
        res = dict(davis=davis_tail(model, n_targets),
                   jhmdb=jhmdb_tail(model, n_targets, out),
                   vip=vip_tail(model, n_targets, out))
    del model
    res["bf16"] = bf16_encode()
    print(f"eval tail on {card}: propagation ms/target DAVIS "
          f"{res['davis']['prop_ms_per_target']:.3f}, JHMDB "
          f"{res['jhmdb']['prop_ms_per_target']:.3f}, VIP "
          f"{res['vip']['prop_ms_per_target']:.3f}; host metrics: J and F "
          f"{res['davis']['metric_ms_per_frame']:.2f} ms/frame, "
          f"process_pose + PCK {res['jhmdb']['pose_ms_per_target'] + res['jhmdb']['pck_ms_per_target']:.3f} "
          f"ms/target, fast_hist + show_result "
          f"{res['vip']['metric_ms_per_target']:.2f} ms/target; encode "
          f"ms/frame bf16 {res['bf16']['bfloat16_ms_per_frame']:.3f}, f32 "
          f"{res['bf16']['float32_ms_per_frame']:.3f}", flush=True)
    return res


def _walk_inputs(B, T, N, C, rate, seed, absent=None):
    """Unit node rows, edge-drop masks and an upstream gradient; ``absent``
    ``(lo, hi)`` zeroes ``lo..hi-1`` node slots of every frame, a different
    set per frame (the superpixel path's absent slots)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, T, N, C), generator=g, device="cuda")
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    if absent is not None:
        order = torch.rand((B, T, N), generator=g, device="cuda").argsort(-1)
        n_absent = torch.randint(absent[0], absent[1], (B, T, 1), generator=g,
                                 device="cuda")
        q = q * (order >= n_absent)[..., None]
    m12, m21 = ((torch.rand((B, T - 1, N, N), generator=g, device="cuda")
                 < rate).to(torch.uint8) for _ in range(2))
    dl = torch.randn((B, T - 2), generator=g, device="cuda")
    return q, m12, m21, dl


def walk_bounds(B, T, N, C) -> dict:
    """Least times of the two kernels on this card: bytes (each input read
    once, each output written once) over the HBM rate, f32 operations (the
    products' multiply-adds) over the f32 peak."""
    S = T - 1
    nn, q_bytes = B * S * N * N, 4 * B * T * N * C
    # the four (B, S, N, N) f32 residuals the function needs: D12, D21, F,
    # B (the kernels' P and Q are their design's extra bytes, not counted)
    fwd_bytes = q_bytes + 2 * nn + 4 * 4 * nn + 2 * 4 * B * (S - 1)
    bwd_bytes = q_bytes + 4 * 4 * nn + 4 * B * (S - 1) + q_bytes
    fwd_flops = 2 * B * S * N * N * C + 2 * 3 * B * (S - 1) * N ** 3
    bwd_flops = B * ((S - 1) * (14 * N ** 3 + 4 * N * N * C) + 4 * N * N * C)
    out = {}
    for name, nbytes, flops in (("fwd", fwd_bytes, fwd_flops),
                                ("bwd", bwd_bytes, bwd_flops)):
        b_ms, o_ms = nbytes / HBM_RATE * 1e3, flops / FP32_PEAK * 1e3
        out[name] = dict(bytes=nbytes, flops=flops, bound_ms=max(b_ms, o_ms),
                         bound_by="bytes" if b_ms >= o_ms else "operations")
    return out


def walk_phase_us(fn, n: int = 20, tries: int = 3) -> dict:
    """Device microseconds per launch of each ``walk_*`` kernel that
    ``fn()`` launches (each once a call), from ``torch.profiler`` over
    ``n`` calls; empty (printed as not measured) if the profiler saw none
    in ``tries`` windows. A reading only: the kernels' checks do not depend
    on it."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            m = re.search(r"walk_\w+", e.key)
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            if m and t and e.count:
                out[m.group(0)] = t / e.count
        if out:
            break
    return out


def walk_kernels_vs_plain() -> dict:
    """Phase 5: the walk kernels and their plain version on the same inputs,
    at the flagship shape, at the gate's edge and at the superpixel step's
    shape with 8-14 absent node slots (all-zero q rows) in every frame.
    Tolerances: losses rtol
    1e-5, accuracies 1e-6, residuals rtol 1e-5 + atol 1e-6, dq 2e-5 of its
    largest entry (f32 products summed in another order). A second run of
    the kernels must be bitwise equal to the first."""
    res = {}
    print(f"walk kernels: {wk.DEVICE_LAUNCHES} device launches per "
          f"walk_fwd call and per walk_bwd call", flush=True)
    for tag, shape, absent in (
            ("flagship", (BATCH, CLIP_LEN, N_PATCHES, 128), None),
            ("edge", (BATCH, 10, 128, 512), None),
            ("superpixel", (SP_BATCH, SP_CLIP, MAX_SP, 128), (8, 15))):
        q, m12, m21, dl = _walk_inputs(*shape, rate=EDGEDROP, seed=4,
                                       absent=absent)
        before = (wk.walk_fwd.launches, wk.walk_bwd.launches)
        got = wk.walk_fwd(q, m12, m21, WALK_TEMP)
        got_dq = wk.walk_bwd(q, *got[2:], dl, WALK_TEMP)
        want = wk.fused_walk_plain_fwd(q, m12, m21, WALK_TEMP)
        want_dq = wk.fused_walk_plain_bwd(q, *want[2:], dl, WALK_TEMP)
        torch.cuda.synchronize()
        err = dict(
            losses=float((got[0] - want[0]).abs().max()),
            loss_rel=float(((got[0] - want[0]).abs() / want[0].abs()).max()),
            accs=float((got[1] - want[1]).abs().max()),
            residuals=float(max((g - w).abs().max() for g, w in
                                zip(got[2:], want[2:]))),
            dq=float((got_dq - want_dq).abs().max()),
            dq_scale=float(want_dq.abs().max()))
        res_ok = all(torch.allclose(g, w, rtol=1e-5, atol=1e-6)
                     for g, w in zip(got[2:], want[2:]))
        again = wk.walk_fwd(q, m12, m21, WALK_TEMP)
        again_dq = wk.walk_bwd(q, *again[2:], dl, WALK_TEMP)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in
                   zip((*got, got_dq), (*again, again_dq))):
            fail(f"two runs of the walk kernels differ at {tag} {shape}")
        if not (all(torch.isfinite(t).all() for t in (*got, got_dq))
                and err["loss_rel"] <= 1e-5 and err["accs"] <= 1e-6
                and res_ok and err["dq"] <= 2e-5 * err["dq_scale"]):
            fail(f"walk kernels disagree with their plain version at {tag} "
                 f"{shape}: {err}")
        res_fwd = got[2:]
        times = dict(
            fwd_ms=cuda_ms(lambda: wk.walk_fwd(q, m12, m21, WALK_TEMP), 50),
            bwd_ms=cuda_ms(lambda: wk.walk_bwd(q, *res_fwd, dl, WALK_TEMP), 50),
            plain_fwd_ms=cuda_ms(
                lambda: wk.fused_walk_plain_fwd(q, m12, m21, WALK_TEMP), 20),
            plain_bwd_ms=cuda_ms(lambda: wk.fused_walk_plain_bwd(
                q, *res_fwd, dl, WALK_TEMP), 20))
        phases = dict(
            fwd=walk_phase_us(lambda: wk.walk_fwd(q, m12, m21, WALK_TEMP)),
            bwd=walk_phase_us(lambda: wk.walk_bwd(q, *res_fwd, dl, WALK_TEMP)))
        wk.walk_fwd.launches, wk.walk_bwd.launches = before  # not the path's
        bounds = walk_bounds(*shape)
        res[tag] = dict(shape=shape, err=err, bounds=bounds, **times,
                        device_us=phases)
        zero_rows = int((q.abs().amax(-1) == 0).sum())
        res[tag]["absent_slots"] = zero_rows
        print(f"walk kernels vs plain at {tag} (B,T,N,C)={shape}, "
              f"{zero_rows} absent node slots, edge-drop "
              f"rate {EDGEDROP}: max|d| losses {err['losses']:.3e} (rel "
              f"{err['loss_rel']:.2e}), accs {err['accs']:.1e}, residuals "
              f"{err['residuals']:.3e}, dq {err['dq']:.3e} of {err['dq_scale']:.3e} "
              f"(tolerance: losses rtol 1e-5, accs 1e-6, residuals rtol 1e-5 "
              f"+ 1e-6, dq 2e-5 of its largest entry)", flush=True)
        print(f"  fwd {times['fwd_ms']:.4f} ms (plain {times['plain_fwd_ms']:.4f}, "
              f"bound {bounds['fwd']['bound_ms']:.5f} by {bounds['fwd']['bound_by']})"
              f"; bwd {times['bwd_ms']:.4f} ms (plain {times['plain_bwd_ms']:.4f}, "
              f"bound {bounds['bwd']['bound_ms']:.5f} by {bounds['bwd']['bound_by']})"
              f"; two runs bitwise equal", flush=True)
        for d, ks in phases.items():
            print(f"  walk_{d} device time per call "
                  + (f"{sum(ks.values()):.1f} us: " + ", ".join(
                      f"{k} {v:.1f}" for k, v in ks.items()) if ks
                     else "not measured (the profiler saw no kernel)"),
                  flush=True)
        if tag == "edge":
            for d in ("fwd", "bwd"):
                under = times[f"{d}_ms"] < times[f"plain_{d}_ms"]
                print(f"  walk_{d} at the edge: {'under' if under else 'NOT under'}"
                      f" its plain version ({times[f'{d}_ms']:.4f} vs "
                      f"{times[f'plain_{d}_ms']:.4f} ms)", flush=True)
    return res


def walk_gate_sweep(batch: int = BATCH) -> dict:
    """The fused walk (``walk.cu`` forward + backward, through
    ``fused_walk_loss`` and autograd) against ``core/walk.py``'s
    ``crw_walk_loss`` forward + backward on the same unit q and edge-drop
    masks, at batch 8 over ``WALK_SWEEP``: the measurement that bounds
    ``fused_walk="auto"`` (``models/crw.py::fused_walk_route``). Prints
    both times, their ratio, whether the default config's gate takes the
    fused walk there and whether that agrees with the sweep."""
    from videowalk_tpu_torch.core.walk import crw_walk_loss
    from videowalk_tpu_torch.models.crw import fused_walk_route
    before = (wk.walk_fwd.launches, wk.walk_bwd.launches)
    rows = []
    for T in WALK_SWEEP["T"]:
        for N in WALK_SWEEP["N"]:
            for C in WALK_SWEEP["C"]:
                q, m12, m21, _ = _walk_inputs(batch, T, N, C, rate=EDGEDROP,
                                              seed=5)
                q = q.permute(0, 3, 1, 2).contiguous().requires_grad_()
                masks = (m12.bool(), m21.bool())

                def run(loss_fn):
                    loss, _ = loss_fn(q, WALK_TEMP, masks=masks)
                    torch.autograd.grad(loss, q)
                fused_ms = cuda_ms(lambda: run(wk.fused_walk_loss), 5, 1)
                core_ms = cuda_ms(lambda: run(crw_walk_loss), 5, 1)
                rows.append(dict(T=T, N=N, C=C, fused_ms=fused_ms,
                                 core_ms=core_ms, ratio=fused_ms / core_ms,
                                 gate=fused_walk_route(CRWConfig(), T, N, C)))
                del q, m12, m21, masks
    wk.walk_fwd.launches, wk.walk_bwd.launches = before   # not the path's
    print(f"fused walk vs core walk, forward + backward at batch {batch} "
          f"(ms; ratio fused/core; gate = fused_walk='auto' takes it):",
          flush=True)
    for r in rows:
        print(f"  T={r['T']:2d} N={r['N']:3d} C={r['C']:3d}  fused "
              f"{r['fused_ms']:8.3f}  core {r['core_ms']:8.3f}  ratio "
              f"{r['ratio']:6.3f}  gate {r['gate']}", flush=True)
    agree = sum((r["ratio"] < 1) == r["gate"] for r in rows)
    print(f"  the gate agrees with the sweep on {agree} of {len(rows)} "
          f"shapes", flush=True)
    return dict(batch=batch, rows=rows, gate_agrees=agree)


def px_modes() -> list[str]:
    """``rconv_slab_px``'s modes in the order of ``pxk::Mode`` in its
    source, which is how ptxas's mangled names number them."""
    import re

    with open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                           "rconv_slab.cu")) as fh:
        m = re.search(r"enum Mode \{([^}]*)\}", fh.read())
    if not m:
        raise RuntimeError("rconv_slab.cu declares no enum Mode")
    return [v.strip() for v in m.group(1).split(",")]


def slab_kernel_name(mangled: str, modes: list[str]) -> str | None:
    """The readable instantiation of a mangled slab kernel name:
    ``rconv_slab_px<BN, MODE>``, ``rconv_slab_dw<BNIN>``; None for any other
    function."""
    import re

    m = re.search(r"(rconv_slab_(?:px|dw))I((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return None
    args = re.findall(r"L[ib](\d+)E", m.group(2))
    if m.group(1) == "rconv_slab_px":
        return f"rconv_slab_px<{args[0]}, {modes[int(args[1])]}>"
    return f"rconv_slab_dw<{'true' if args[0] == '1' else 'false'}>"


def wgmma_verdicts(log: str) -> dict:
    """ptxas's verdict on each slab kernel of a build log: whether it
    serializes the kernel's ``wgmma`` (C7510-C7515: the reason as ptxas
    gives it), by instantiation: ``rconv_slab_px<BN, MODE>``,
    ``rconv_slab_dw<BNIN>``."""
    import re

    modes = px_modes()
    out = {}
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        name = m and slab_kernel_name(m.group(1), modes)
        if name:
            out.setdefault(name, "not serialized")
        c = re.search(r"\((C751\d)\)(.*?)(?:(?:in|for) the function '([^']+)')",
                      line)
        if c and slab_kernel_name(c.group(3), modes):
            out[slab_kernel_name(c.group(3), modes)] = (
                f"serialized ({c.group(1)}:{c.group(2).rstrip()})")
    return out


def ptxas_resources(log: str) -> dict:
    """Each slab kernel's registers and spill bytes from ptxas's ``-v``
    lines of a build log: ``{instantiation: dict(registers, spill_stores,
    spill_loads)}``."""
    import re

    modes = px_modes()
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )([^' ]+)",
                      line)
        if m:
            name = slab_kernel_name(m.group(1), modes)
            if name:
                out.setdefault(name, dict(registers=None, spill_stores=0,
                                          spill_loads=0))
            continue
        if name is None:
            continue
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if sp:
            out[name]["spill_stores"] = int(sp.group(1))
            out[name]["spill_loads"] = int(sp.group(2))
        reg = re.search(r"Used (\d+) registers", line)
        if reg:
            out[name]["registers"] = int(reg.group(1))
    return out


def rconv_counts() -> dict:
    return {name: f.launches for name, f in RCONV}


def set_rconv_counts(counts: dict) -> None:
    for name, f in RCONV:
        f.launches = counts[name]


def bn_counts() -> dict:
    return {name: f.launches for name, f in BN}


def zero_bn_counts() -> None:
    for _, f in BN:
        f.launches = 0


def check_bn_counts(tag: str, counts: dict, n_steps: int) -> dict:
    """The BN kernels' launches per step of a train-mode trunk's timed
    steps: each pass in ``BN_EVERY_STEP`` at least once a step, and every
    count the same each step."""
    if any(counts[k] == 0 for k in BN_EVERY_STEP) or any(
            v % n_steps for v in counts.values()):
        fail(f"{tag}: BN kernel launches {counts} in {n_steps} steps: want "
             f"each of {BN_EVERY_STEP} every step, the same count each step")
    return {k: v // n_steps for k, v in counts.items()}


def rconv_bounds(N, cin, cout, H, W, itemsize=2, peak=BF16_PEAK) -> dict:
    """Least times of the seven kernels: each input read once and each
    output written once over the HBM rate, against the bf16 (or f32)
    multiply-adds over the peak; the moments add 2*Cout f32, the BN-input
    modes a and b (2*Cin f32), #7 also the raw x and da, db."""
    M = N * H * W
    flops = 2 * M * 9 * cin * cout
    wb, xb, yb = 9 * cin * cout * itemsize, M * cin * itemsize, M * cout * itemsize
    nbytes = dict(fwd=xb + wb + yb, fwd_stats=xb + wb + yb + 8 * cout,
                  dx=yb + wb + xb, dw=xb + yb + wb,
                  fwd_bnin_stats=xb + wb + yb + 8 * cout + 8 * cin,
                  dx_bnin=yb + wb + 2 * xb + 16 * cin,
                  dw_bnin=xb + yb + wb + 8 * cin)
    out = {}
    for name, b in nbytes.items():
        b_ms, o_ms = b / HBM_RATE * 1e3, flops / peak * 1e3
        out[name] = dict(bytes=b, flops=flops, bound_ms=max(b_ms, o_ms),
                         bound_by="bytes" if b_ms >= o_ms else "operations")
    return out


def moment_err(s1, s2, y) -> float:
    """The largest per-channel error of ``(s1, s2)`` against the f32 sums
    of ``y``: |s1 - sum y| / sum |y| and |s2 - sum y^2| / sum y^2."""
    yf = y.float()
    m1, m2 = yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))
    return float(torch.maximum((s1 - m1).abs() / yf.abs().sum((0, 2, 3)),
                               (s2 - m2).abs() / m2).max())


def fold_leg_of_row1(x, w, gy) -> torch.Tensor:
    """What the row-1 fold leg of the dy = 0 taps adds to dx (f32): output
    row 0's dy = 0 taps read pad row -1, the mirror of input row 1, so the
    plain backward of gy's row 0 through those taps alone lands on row 1
    only. dx minus this is the planted fault of the dx check."""
    w0 = torch.zeros_like(w)
    w0[:, :, 0] = w[:, :, 0]
    g0 = torch.zeros_like(gy)
    g0[:, :, 0] = gy[:, :, 0]
    return rc.reflect_conv_plain_bwd(x.float(), w0.float(), g0.float())[0]


def rconv_kernels_vs_plain() -> dict:
    """The reflect-conv kernels #4, #5, #9, #10 against their plain version
    on the same bf16 inputs at the step's shapes, and their times.
    Tolerances, relative to each output's largest entry: y and dW 1e-2, dx
    2e-2 (each side rounds f32 sums to bf16, ~4e-3; the plain dx rounds the
    padded gradient before folding the pad back); moments per channel, as
    ``MOM_TOL`` states, against the kernel's own cast y and the plain y.
    Two planted faults (s1 zeroed; one forward tile of rows left out of
    both sums) must fail that check, #4's and #5's y with the border of a
    zero-padded conv in place of the reflection must fail the y check, and
    dx without the row-1 fold leg of the dy=0 taps must fail the dx check;
    two runs of #4, of #5 (y, s1, s2) and of dW must be bitwise equal.
    ``plain_ms`` is the plain version as the
    wrapper would call it (forward: ``F.pad`` + ``conv2d``, + its f32 sums
    for the moments; backward: autograd of the same, dx and dW together);
    ``library_ms`` is the PyTorch calls of the same function: ``F.pad`` +
    cuDNN ``conv2d`` forward (followed by the f32 sums of y and y^2 for the
    moments), and on a kept graph the autograd backward for x alone (dx:
    cuDNN dgrad and the pad's fold), for w alone (dW: cuDNN wgrad on the
    padded x) and for both."""
    res = {}
    saved = rconv_counts()
    for tag, N, cin, cout, H, W in RCONV_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(cin + cout + H)
        cl = torch.channels_last
        x = torch.randn((N, cin, H, W), generator=g, device="cuda",
                        dtype=torch.bfloat16).contiguous(memory_format=cl)
        gy = torch.randn((N, cout, H, W), generator=g, device="cuda",
                         dtype=torch.bfloat16).contiguous(memory_format=cl)
        w = (torch.randn((cout, cin, 3, 3), generator=g, device="cuda")
             / (9 * cin) ** 0.5).to(torch.bfloat16)
        got = dict(fwd=rc.reflect_conv_fwd(x, w),
                   fwd_stats=rc.reflect_conv_fwd_stats(x, w),
                   dx=rc.reflect_conv_dx(gy, w, x),
                   dw=rc.reflect_conv_dw(x, gy, w))
        dw_again = rc.reflect_conv_dw(x, gy, w)
        stats_again = rc.reflect_conv_fwd_stats(x, w)
        fwd_again = rc.reflect_conv_fwd(x, w)
        y_ref = rc.reflect_conv_plain(x, w)
        dx_ref, dw_ref = rc.reflect_conv_plain_bwd(x, w, gy)
        ys, s1, s2 = got["fwd_stats"]
        # a y with the border of a zero-padded conv in place of the reflection
        zero_pad = (torch.nn.functional.conv2d(x, w, padding=1).float()
                    - y_ref.float())
        tile = ys.permute(0, 2, 3, 1).reshape(-1, cout)[
            :rc._slab_lib().rconv_slab_bm()].float()
        faults = dict(s1_zeroed=(torch.zeros_like(s1), s2),
                      tile_left_out=(s1 - tile.sum(0),
                                     s2 - (tile * tile).sum(0)))
        torch.cuda.synchronize()

        def rel(a, b):
            return float((a.float() - b.float()).abs().max()
                         / b.float().abs().max())

        err = dict(fwd=rel(got["fwd"], y_ref), dx=rel(got["dx"], dx_ref),
                   dw=rel(got["dw"], dw_ref),
                   dw_repeat_equal=bool(torch.equal(got["dw"], dw_again)),
                   planted_dx=rel(got["dx"].float() - fold_leg_of_row1(x, w, gy),
                                  dx_ref),
                   moments_own=moment_err(s1, s2, ys),
                   moments_ref=moment_err(s1, s2, y_ref),
                   planted={k: dict(own=moment_err(*f, ys),
                                    ref=moment_err(*f, y_ref))
                            for k, f in faults.items()},
                   planted_y_zero_pad=rel(ys.float() + zero_pad, y_ref),
                   planted_fwd_zero_pad=rel(got["fwd"].float() + zero_pad,
                                            y_ref),
                   stats_repeat_equal=all(torch.equal(p, q) for p, q in
                                          zip(got["fwd_stats"], stats_again)),
                   fwd_repeat_equal=bool(torch.equal(got["fwd"], fwd_again)),
                   y_stats_close=rel(ys, got["fwd"]))
        m1, m2 = rc.moments_plain(y_ref)
        abs_err = dict(fwd=float((got["fwd"].float() - y_ref.float()).abs().max()),
                       fwd_stats=float(max((s1 - m1).abs().max(),
                                           (s2 - m2).abs().max())),
                       dx=float((got["dx"].float() - dx_ref.float()).abs().max()),
                       dw=float((got["dw"].float() - dw_ref.float()).abs().max()))
        ok = (err["fwd"] <= 1e-2 and err["dw"] <= 1e-2 and err["dx"] <= 2e-2
              and err["moments_own"] <= MOM_TOL["own"]
              and err["moments_ref"] <= MOM_TOL["ref"]
              and err["y_stats_close"] <= 1e-2 and err["dw_repeat_equal"]
              and err["stats_repeat_equal"] and err["fwd_repeat_equal"]
              and all(torch.isfinite(t).all() for t in
                      (got["fwd"], got["dx"], got["dw"], s1, s2)))
        print(f"reflect-conv kernels vs plain at {tag} (N,Cin,Cout,H,W)="
              f"{(N, cin, cout, H, W)} bf16: |d|/max y {err['fwd']:.2e}, dx "
              f"{err['dx']:.2e}, dW {err['dw']:.2e}, #5's y against #4's "
              f"{err['y_stats_close']:.2e} (two runs bitwise equal: #4 "
              f"{err['fwd_repeat_equal']}, #5 {err['stats_repeat_equal']}, dW "
              f"{err['dw_repeat_equal']}); y with a zero-padded border "
              f"(planted faults) #4 {err['planted_fwd_zero_pad']:.2e}, #5 "
              f"{err['planted_y_zero_pad']:.2e}; dx without the row-1 fold leg of the "
              f"dy=0 taps (planted fault) {err['planted_dx']:.2e}; moments per channel "
              f"{err['moments_own']:.2e} of the kernel's y, "
              f"{err['moments_ref']:.2e} of the plain y; planted faults "
              f"{err['planted']} (tolerance: y, dW 1e-2, dx 2e-2 of the "
              f"largest entry; moments {MOM_TOL} of each channel's sum |y| "
              f"and sum y^2)", flush=True)
        if not ok:
            fail(f"reflect-conv kernels disagree with their plain version at "
                 f"{tag}: {err}")
        if any(v[k] <= MOM_TOL[k] for v in err["planted"].values()
               for k in MOM_TOL):
            fail(f"the moment check passes a planted fault at {tag}: "
                 f"{err['planted']}")
        if err["planted_dx"] <= 2e-2:
            fail(f"the dx check passes a planted fault at {tag}: "
                 f"{err['planted_dx']:.2e}")
        if min(err["planted_y_zero_pad"], err["planted_fwd_zero_pad"]) <= 1e-2:
            fail(f"the y check passes a zero-padded border at {tag}: "
                 f"#4 {err['planted_fwd_zero_pad']:.2e}, #5 "
                 f"{err['planted_y_zero_pad']:.2e}")
        del got, y_ref, dx_ref, dw_ref, tile, faults, dw_again, stats_again
        del fwd_again, zero_pad
        xx = x.detach().requires_grad_()
        ww = w.detach().requires_grad_()
        yy = torch.nn.functional.conv2d(
            torch.nn.functional.pad(xx, (1, 1, 1, 1), mode="reflect"), ww)
        reps = 10
        times = dict(
            fwd=cuda_ms(lambda: rc.reflect_conv_fwd(x, w), reps),
            fwd_stats=cuda_ms(lambda: rc.reflect_conv_fwd_stats(x, w), reps),
            dx=cuda_ms(lambda: rc.reflect_conv_dx(gy, w, x), reps),
            dw=cuda_ms(lambda: rc.reflect_conv_dw(x, gy, w), reps))
        plain = dict(
            fwd=cuda_ms(lambda: rc.reflect_conv_plain(x, w), reps),
            fwd_stats=cuda_ms(lambda: rc.moments_plain(
                rc.reflect_conv_plain(x, w)), reps),
            bwd=cuda_ms(lambda: rc.reflect_conv_plain_bwd(x, w, gy), reps))
        library = dict(
            fwd=cuda_ms(lambda: torch.nn.functional.conv2d(
                torch.nn.functional.pad(x, (1, 1, 1, 1), mode="reflect"), w),
                reps),
            bwd=cuda_ms(lambda: torch.autograd.grad(
                yy, (xx, ww), gy, retain_graph=True), reps),
            dx=cuda_ms(lambda: torch.autograd.grad(
                yy, xx, gy, retain_graph=True), reps),
            dw=cuda_ms(lambda: torch.autograd.grad(
                yy, ww, gy, retain_graph=True), reps))
        library["fwd_stats"] = cuda_ms(lambda: rc.moments_plain(
            torch.nn.functional.conv2d(torch.nn.functional.pad(
                x, (1, 1, 1, 1), mode="reflect"), w)), reps)
        del yy, xx, ww
        bounds = rconv_bounds(N, cin, cout, H, W)
        res[tag] = dict(shape=(N, cin, cout, H, W), err=err, abs_err=abs_err,
                        ms=times, plain_ms=plain, library_ms=library,
                        bounds=bounds)
        for name in ("fwd", "fwd_stats", "dx", "dw"):
            p = plain.get(name, plain["bwd"])
            print(f"  {name:9s} {times[name]:8.3f} ms (plain {p:8.3f}, "
                  f"library {library[name]:8.3f}, bound "
                  f"{bounds[name]['bound_ms']:.3f} by "
                  f"{bounds[name]['bound_by']})", flush=True)
        bnin = bnin_kernels_vs_plain(tag, x, w, gy, reps)
        for k in ("err", "abs_err", "ms", "plain_ms", "library_ms"):
            res[tag][k].update(bnin[k])
        del x, w, gy
        torch.cuda.empty_cache()
    set_rconv_counts(saved)                 # comparison launches do not count
    return res


def ragged_bnin_moments(cin, a, b, w) -> dict:
    """#6 on 3 images of 8x8 (192 pixels: the second 128-pixel tile holds
    64 rows past M) with ``b`` made positive on every channel, so that
    ``relu(b)`` is nonzero everywhere: y against the plain version, the
    moments per channel against the kernel's y and the plain y, and the
    planted fault of the 64 empty rows counted as ``relu(b)``: each such
    row's y is the conv of a constant ``relu(b)`` image."""
    g = torch.Generator(device="cuda").manual_seed(cin + 1)
    x = torch.randn((3, cin, 8, 8), generator=g, device="cuda",
                    dtype=torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)
    bp = b.abs() + 0.1
    y, s1, s2 = rc.reflect_conv_fwd_bnin_stats(x, a, bp, w)
    y_ref = rc.reflect_conv_plain(rc.bnin_plain(x, a, bp)[0], w)
    flat = torch.relu(bp).to(x.dtype)[None, :, None, None].expand(1, cin, 8, 8)
    yc = rc.reflect_conv_plain(flat.contiguous(), w)[0, :, 0, 0].float()
    empty = 128 * 2 - 3 * 64
    fault = (s1 + empty * yc, s2 + empty * yc * yc)
    return dict(
        ragged_y=float((y.float() - y_ref.float()).abs().max()
                       / y_ref.float().abs().max()),
        ragged_moments_own=moment_err(s1, s2, y),
        ragged_moments_ref=moment_err(s1, s2, y_ref),
        planted_ragged_relu_b=min(moment_err(*fault, y),
                                  moment_err(*fault, y_ref)))


def bnin_kernels_vs_plain(tag: str, x, w, gy, reps: int) -> dict:
    """The BN-input kernels #6, #7, #8 against their plain version on the
    same bf16 inputs, with ``a`` positive and ``b`` of both signs (about
    half of ``relu(a*x + b)`` is zero), and their times. y and dW within
    1e-2, dx within 2e-2 of each output's largest entry; s1/s2 per channel
    as ``MOM_TOL``; da and db per channel within ``DAB_TOL`` of that
    channel's sum |dxn*g*x| and sum |dxn*g| (f32 sums of the plain f32
    dxn). The kernels gate by ``fmaf(x, a, b) > 0``, the plain version by
    ``x*a + b > 0`` with the product rounded first: an element whose
    pre-activation lies within one f32 rounding of 0 may be gated
    differently and then moves one dx entry by a whole dxn entry; the share
    of such elements is printed. Two runs of #6 (y, s1, s2), of #7 (dx, da,
    db) and of #8 must be bitwise equal, and faults planted in the kernels'
    own outputs must fail the checks: #6's y without the ReLU on channels
    0-7; dx with the gate dropped on image 0's row 0; da
    and db without the last 8 rows of every 128-pixel tile (a row group of
    the block's sums lost; one whole tile left out is also printed, but at
    the flagship it is 1/1568 of a channel's pixels and may pass); dW with
    the ReLU left out of channels 0-7 (the rebuild of one 16-byte vector
    of x). #6 also runs on a ragged last tile (3 images of 8x8: 64 of the
    second tile's 128 rows lie past M) with ``b > 0`` on every channel:
    its moments per channel within ``MOM_TOL["own"]`` of its own y and
    ``RAGGED_MOM_TOL`` of the plain y, and the same moments with the 64
    empty rows counted as ``relu(b)`` (the conv of a constant ``relu(b)``
    image, as zero-filled slab vectors rebuilt as ``relu(b)`` would give)
    must fail. ``plain_ms``:
    the plain version as the wrappers call it (the f32 affine + ReLU pass,
    ``F.pad`` + ``conv2d`` and the sums; backward: the f32 conv's input
    gradient with the gate and sums, and autograd's dW of the rebuilt xn).
    ``library_ms``: the PyTorch calls of the same function on a kept graph
    of the elementwise affine + ReLU, ``F.pad`` + cuDNN ``conv2d`` and the
    two sums: that forward; for #7 its autograd backward for (x, a, b)
    alone (cuDNN dgrad, the pad's fold, the ReLU's and affine's backward),
    for #8 for w alone (cuDNN wgrad on the padded xn); ``bnin_bwd`` both."""
    F = torch.nn.functional
    cin = x.shape[1]
    g = torch.Generator(device="cuda").manual_seed(cin)
    a = torch.randn((cin,), generator=g, device="cuda").abs() + 0.5
    b = torch.randn((cin,), generator=g, device="cuda") * 0.5
    y, s1, s2 = rc.reflect_conv_fwd_bnin_stats(x, a, b, w)
    dx, da, db = rc.reflect_conv_dx_bnin(gy, w, x, a, b)
    dw = rc.reflect_conv_dw_bnin(x, a, b, gy, w)
    again = (*rc.reflect_conv_fwd_bnin_stats(x, a, b, w),
             *rc.reflect_conv_dx_bnin(gy, w, x, a, b),
             rc.reflect_conv_dw_bnin(x, a, b, gy, w))
    xn, gate = rc.bnin_plain(x, a, b)
    y_ref = rc.reflect_conv_plain(xn, w)
    dx_ref, da_ref, db_ref = rc.reflect_conv_dx_bnin_plain(gy, w, x, a, b)
    dw_ref = rc.reflect_conv_plain_bwd(xn, w, gy)[1]
    torch.cuda.synchronize()
    # per-channel da/db: dxn*g is dx_ref's f32 precursor; rebuild its mass
    xf = x.float()
    fused_gate = torch.addcmul(b[None, :, None, None], xf,
                               a[None, :, None, None]) > 0
    flips = float((fused_gate != gate).float().mean())
    av = a[None, :, None, None]
    dxg = torch.where(gate, dx_ref.float() / av, torch.zeros_like(xf))
    mass_a = (dxg * xf).abs().sum((0, 2, 3))
    mass_b = dxg.abs().sum((0, 2, 3))
    del dxg, fused_gate

    def dab_err(da_, db_):
        return float(torch.maximum(
            (da_ - da_ref).abs() / mass_a.clamp_min(1e-30),
            (db_ - db_ref).abs() / mass_b.clamp_min(1e-30)).max())

    # planted faults, from the kernels' own outputs
    N, _, H, W = x.shape
    dxn0 = rc.reflect_conv_plain_bwd(xf[:1], w.float(), gy[:1].float())[0]
    dx_fault = dx.float().clone()
    dx_fault[:1, :, :1] += torch.where(gate[:1, :, :1], 0.0,
                                       dxn0[:, :, :1] * av)
    dxg_k = dx.float() / av                 # the kernel's dxn*g, bf16-rounded
    pix = torch.arange(N * H * W, device="cuda").reshape(N, 1, H, W) % 128

    def left_out(mask):
        return (da - (dxg_k * xf * mask).sum((0, 2, 3)),
                db - (dxg_k * mask).sum((0, 2, 3)))

    xneg = torch.zeros_like(x)
    xneg[:, :8] = torch.clamp_max(xf[:, :8] * av[:, :8] + b[None, :8, None, None],
                                  0.0).to(x.dtype)
    dw_fault = dw.float() + rc.reflect_conv_plain_bwd(xneg, w, gy)[1].float()
    y_fault = y.float() + rc.reflect_conv_plain(xneg, w).float()
    del xneg, dxn0
    ragged = ragged_bnin_moments(cin, a, b, w)

    def rel(p, q):
        return float((p.float() - q.float()).abs().max() / q.float().abs().max())

    err = dict(fwd_bnin_stats=rel(y, y_ref), dx_bnin=rel(dx, dx_ref),
               dw_bnin=rel(dw, dw_ref),
               bnin_moments_own=moment_err(s1, s2, y),
               bnin_moments_ref=moment_err(s1, s2, y_ref),
               da=float(((da - da_ref).abs() / mass_a.clamp_min(1e-30)).max()),
               db=float(((db - db_ref).abs() / mass_b.clamp_min(1e-30)).max()),
               gate_share=float(gate.float().mean()), gate_flips=flips,
               bnin_repeat_equal=all(torch.equal(p, q) for p, q in
                                     zip((y, s1, s2, dx, da, db, dw), again)),
               planted_y_relu=rel(y_fault, y_ref),
               **ragged,
               planted_dx_gate=rel(dx_fault, dx_ref),
               planted_dab_rows=dab_err(*left_out(pix >= 120)),
               planted_dab_tile=dab_err(*left_out(torch.arange(
                   N * H * W, device="cuda").reshape(N, 1, H, W) < 128)),
               planted_dw_relu=rel(dw_fault, dw_ref))
    del dx_fault, dxg_k, pix, dw_fault, y_fault, xf, again
    m1, m2 = rc.moments_plain(y_ref)
    abs_err = dict(
        fwd_bnin_stats=float(max((y.float() - y_ref.float()).abs().max(),
                                 (s1 - m1).abs().max(), (s2 - m2).abs().max())),
        dx_bnin=float(max((dx.float() - dx_ref.float()).abs().max(),
                          (da - da_ref).abs().max(), (db - db_ref).abs().max())),
        dw_bnin=float((dw.float() - dw_ref.float()).abs().max()))
    ok = (err["fwd_bnin_stats"] <= 1e-2 and err["dw_bnin"] <= 1e-2
          and err["dx_bnin"] <= 2e-2
          and err["bnin_moments_own"] <= MOM_TOL["own"]
          and err["bnin_moments_ref"] <= MOM_TOL["ref"]
          and err["da"] <= DAB_TOL and err["db"] <= DAB_TOL
          and 0.2 < err["gate_share"] < 0.8 and err["bnin_repeat_equal"]
          and err["ragged_y"] <= 1e-2
          and err["ragged_moments_own"] <= MOM_TOL["own"]
          and err["ragged_moments_ref"] <= RAGGED_MOM_TOL
          and all(torch.isfinite(t.float()).all() for t in
                  (y, s1, s2, dx, da, db, dw)))
    print(f"BN-input kernels vs plain at {tag}: share of xn > 0 "
          f"{err['gate_share']:.3f}, gates that differ by the fused "
          f"multiply-add {flips:.2e}; |d|/max y {err['fwd_bnin_stats']:.2e}, "
          f"dx {err['dx_bnin']:.2e}, dW {err['dw_bnin']:.2e}; moments per "
          f"channel {err['bnin_moments_own']:.2e} of the kernel's y, "
          f"{err['bnin_moments_ref']:.2e} of the plain y; da {err['da']:.2e}, "
          f"db {err['db']:.2e} of each channel's sum |dxn*g*x|, sum |dxn*g| "
          f"(tolerance: y, dW 1e-2, dx 2e-2; moments {MOM_TOL}; da, db "
          f"{DAB_TOL}); two runs of #6, #7 and #8 bitwise equal: "
          f"{err['bnin_repeat_equal']}; #6 on a ragged tile with b > 0: y "
          f"{err['ragged_y']:.2e}, moments {err['ragged_moments_own']:.2e} of "
          f"its y, {err['ragged_moments_ref']:.2e} of the plain y (tolerance "
          f"{RAGGED_MOM_TOL}); planted faults: #6's y without the ReLU on "
          f"channels 0-7 {err['planted_y_relu']:.2e}, its ragged moments with "
          f"the empty rows as relu(b) {err['planted_ragged_relu_b']:.2e}, dx "
          f"without the gate "
          f"on image 0's row 0 {err['planted_dx_gate']:.2e}, da/db without "
          f"the last 8 rows of every tile {err['planted_dab_rows']:.2e} "
          f"(without tile 0 alone {err['planted_dab_tile']:.2e}), dW without "
          f"the ReLU on channels 0-7 {err['planted_dw_relu']:.2e}",
          flush=True)
    if not ok:
        fail(f"BN-input kernels disagree with their plain version at {tag}: "
             f"{err}")
    if (err["planted_dx_gate"] <= 2e-2 or err["planted_dab_rows"] <= DAB_TOL
            or err["planted_dw_relu"] <= 1e-2 or err["planted_y_relu"] <= 1e-2
            or err["planted_ragged_relu_b"] <= RAGGED_MOM_TOL):
        fail(f"the BN-input checks pass a planted fault at {tag}: {err}")
    del y, dx, dw, xn, gate, y_ref, dx_ref, dw_ref

    def lib_fwd(xx, aa, bb, ww):
        pre = xx.float() * aa[None, :, None, None] + bb[None, :, None, None]
        yy = F.conv2d(F.pad(torch.relu(pre).to(xx.dtype), (1, 1, 1, 1),
                            mode="reflect"), ww)
        return yy, *rc.moments_plain(yy)

    leaves = [t.detach().requires_grad_() for t in (x, a, b, w)]
    yy = lib_fwd(*leaves)[0]
    times = dict(
        fwd_bnin_stats=cuda_ms(
            lambda: rc.reflect_conv_fwd_bnin_stats(x, a, b, w), reps),
        dx_bnin=cuda_ms(lambda: rc.reflect_conv_dx_bnin(gy, w, x, a, b), reps),
        dw_bnin=cuda_ms(lambda: rc.reflect_conv_dw_bnin(x, a, b, gy, w), reps))
    plain = dict(
        fwd_bnin_stats=cuda_ms(lambda: rc.moments_plain(rc.reflect_conv_plain(
            rc.bnin_plain(x, a, b)[0], w)), reps),
        dx_bnin=cuda_ms(
            lambda: rc.reflect_conv_dx_bnin_plain(gy, w, x, a, b), 3, 1),
        dw_bnin=cuda_ms(lambda: rc.reflect_conv_plain_bwd(
            rc.bnin_plain(x, a, b)[0], w, gy)[1], reps))
    library = dict(
        fwd_bnin_stats=cuda_ms(lambda: lib_fwd(x, a, b, w), reps),
        bnin_bwd=cuda_ms(lambda: torch.autograd.grad(
            yy, leaves, gy, retain_graph=True), reps),
        dx_bnin=cuda_ms(lambda: torch.autograd.grad(
            yy, leaves[:3], gy, retain_graph=True), reps),
        dw_bnin=cuda_ms(lambda: torch.autograd.grad(
            yy, leaves[3:], gy, retain_graph=True), reps))
    del yy, leaves
    bounds = rconv_bounds(x.shape[0], cin, w.shape[0], *x.shape[2:])
    for name in ("fwd_bnin_stats", "dx_bnin", "dw_bnin"):
        print(f"  {name:14s} {times[name]:8.3f} ms (plain "
              f"{plain[name]:8.3f}, library {library[name]:8.3f}, bound "
              f"{bounds[name]['bound_ms']:.3f} by {bounds[name]['bound_by']})",
              flush=True)
    print(f"  library dx + dW of the chain together {library['bnin_bwd']:8.3f}"
          f" ms", flush=True)
    return dict(err=err, abs_err=abs_err, ms=times, plain_ms=plain,
                library_ms=library)


def conv_fwd_flops_per_image() -> int:
    """bench.py:140-151: forward conv FLOPs of the modified ResNet-18 on one
    64 px patch (stride-1 layer3/4), 2*H*W*K*K*Cin*Cout per conv."""
    f = 2 * 32 * 32 * 49 * 3 * 64                      # stem 7x7/2
    f += 4 * 2 * 16 * 16 * 9 * 64 * 64                 # layer1
    f += (2 * 8 * 8 * 9 * 64 * 128 + 2 * 8 * 8 * 64 * 128
          + 3 * 2 * 8 * 8 * 9 * 128 * 128)             # layer2 (+ds)
    f += (2 * 8 * 8 * 9 * 128 * 256 + 2 * 8 * 8 * 128 * 256
          + 3 * 2 * 8 * 8 * 9 * 256 * 256)             # layer3 (+ds)
    f += (2 * 8 * 8 * 9 * 256 * 512 + 2 * 8 * 8 * 256 * 512
          + 3 * 2 * 8 * 8 * 9 * 512 * 512)             # layer4 (+ds)
    return f


def bottleneck_fwd_flops_per_image() -> int:
    """Forward conv FLOPs of the modified ResNet-50 (``scratch50``) on one
    64 px patch, as ``conv_fwd_flops_per_image`` counts ResNet-18's: per
    Bottleneck the 1x1 at the input's size, the 3x3 (stride on it), the
    expanding 1x1 and block 0's projection; 29.30 TFLOP a flagship step
    (three passes)."""
    f = 2 * 32 * 32 * 49 * 3 * 64                      # stem 7x7/2
    cin, hw = 64, 16
    for planes, n_blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 1),
                                     (512, 3, 1)):
        for b in range(n_blocks):
            o = hw // (stride if b == 0 else 1)
            f += (2 * hw * hw * cin * planes + 2 * o * o * 9 * planes * planes
                  + 2 * o * o * planes * 4 * planes)
            if b == 0:
                f += 2 * o * o * cin * 4 * planes      # projection
            cin, hw = 4 * planes, o
    return f


def seeded_crw(cfg: CRWConfig, seed: int, state: dict | None = None) -> CRW:
    """The model, initialized on the CPU from ``seed``; then ``state`` (a
    ``state_dict``) loaded over it, where given."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CRW(cfg)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model


def seeded_ts(cfg: CRWConfig, seed: int, teacher_seed: int
              ) -> CRWTeacherStudent:
    """The teacher-student model on the CPU: the student seeded from
    ``seed``; the teacher loaded as the JAX CLI loads a pretrained one
    (``videowalk_tpu/cli/train.py:476-486``): a CRW's ``state_dict`` (seeded
    from ``teacher_seed``) with its keys prefixed ``teacher.``, through
    ``partial_load``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CRWTeacherStudent(cfg, alpha=TS_ALPHA)
    teacher = seeded_crw(cfg, teacher_seed).state_dict()
    loaded = partial_load({f"teacher.{k}": v for k, v in teacher.items()},
                          model, verbose=False)
    if len(loaded) != len(teacher):
        fail(f"partial_load took {len(loaded)} of the teacher's "
             f"{len(teacher)} tensors")
    return model


def profile_steps(run, n: int = 3, steps_per_run: int = 1) -> dict:
    """``n`` more runs (``run()`` takes ``steps_per_run`` steps) under
    ``torch.profiler``: device time a step by kernel and by kind, and the
    device's idle share of the host clock's window (one compute stream, so
    kernel times add up; host-to-device copies on a side stream are
    counted apart)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for e in prof.key_averages():
        # the program's spans are user annotations on the device's
        # timeline too: their ranges are not kernels
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            kernels[e.key] = kernels.get(e.key, 0.0) + t
    n *= steps_per_run
    side = sum(t for k, t in kernels.items() if k.startswith("Memcpy HtoD"))
    kernels = {k: t for k, t in kernels.items()
               if not k.startswith("Memcpy HtoD")}
    busy = sum(kernels.values())
    if busy <= 0:
        fail("the profiler saw no device time")
    if busy > 1.02 * wall_us:
        fail(f"device time {busy:.0f} us exceeds the host's window "
             f"{wall_us:.0f} us on one stream: events counted twice")
    kinds = {}
    for name, t in kernels.items():
        low = name.lower()
        kind = ("walk kernels" if re.search(r"(^|::)walk_", low) else
                "slic kernels" if "slic_" in low else
                "dilation kernel" if "dilate_l1" in low else
                "reflect-conv kernels" if ("rconv_" in low
                                           or "reduce_rows" in low) else
                "convolutions" if any(w in low for w in (
                    "conv", "cudnn", "xmma", "gemm", "dgrad", "wgrad",
                    "implicit")) else
                "reductions" if "reduce" in low else
                "elementwise" if "elementwise" in low else
                "optimizer" if ("adam" in low or "foreach" in low) else
                "other")
        kinds[kind] = kinds.get(kind, 0.0) + t
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    res = dict(steps=n, wall_ms_per_step=wall_us / n / 1e3,
               device_ms_per_step=busy / n / 1e3,
               idle_share=1 - busy / wall_us,
               host_to_device_copy_ms_per_step=side / n / 1e3,
               kinds_ms_per_step={k: v / n / 1e3 for k, v in
                                  sorted(kinds.items(), key=lambda kv: -kv[1])},
               top_kernels_ms_per_step=[(k[:90], v / n / 1e3) for k, v in top])
    print(f"profile of {n} steps: {res['wall_ms_per_step']:.2f} ms/step by the "
          f"host clock, device busy {res['device_ms_per_step']:.2f} ms/step, "
          f"idle share {res['idle_share']:.3f}", flush=True)
    for k, v in res["kinds_ms_per_step"].items():
        print(f"  {k:13s} {v:9.3f} ms/step", flush=True)
    for k, v in res["top_kernels_ms_per_step"]:
        print(f"  {v:9.3f} ms/step  {k}", flush=True)
    return res


def train_arm(rconv: str, bn_fuse: str, expect: dict, n_steps: int,
              n_warmup: int = 3, profile: bool = False,
              teacher_student: bool = False,
              model_type: str = "scratch") -> dict:
    """``bench.py``'s flagship training step with the reflect convs routed
    by ``rconv`` / ``bn_fuse``: seeded init, ``n_warmup`` steps, then
    ``n_steps`` timed ones with every kernel count zeroed just before and
    read just after. Each walk kernel must run once a step and each
    reflect-conv kernel ``expect[name]`` times a step. ``model_type``
    ``scratch50`` takes the ResNet-50 trunk (and its FLOP count).

    ``teacher_student``: the same step of ``CRWTeacherStudent`` (``seeded_ts``)
    with the teacher frozen; no walk kernel may run, every teacher
    parameter and buffer must be bitwise unchanged after all the steps, and
    the FLOPs count the teacher's forward beside the student's forward and
    backward."""
    dev = torch.device("cuda")
    cfg = CRWConfig(model_type=model_type, temperature=WALK_TEMP,
                    edgedrop_rate=EDGEDROP, dtype=torch.bfloat16,
                    rconv=rconv, bn_fuse=bn_fuse)
    if teacher_student:
        model = seeded_ts(cfg, seed=0, teacher_seed=2)
        teacher0 = {k: v.clone() for k, v in model.teacher.state_dict().items()}
        frozen = ("teacher.",)
    else:
        model, frozen = seeded_crw(cfg, seed=0), ()
    state = create_train_state(model, make_optimizer(lr=3e-4), device=dev,
                               frozen_prefixes=frozen)
    step = make_train_step()
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = torch.randn((BATCH, CLIP_LEN, N_PATCHES, PATCH, PATCH, 3),
                        generator=gen, device=dev)
    for _ in range(n_warmup):
        step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.walk_fwd.launches = wk.walk_bwd.launches = 0   # counts: this path only
    set_rconv_counts(dict.fromkeys(expect, 0))
    zero_bn_counts()
    t0 = time.perf_counter()
    metrics = [step(state, batch, gen) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_steps
    launches = dict(walk_fwd=wk.walk_fwd.launches,
                    walk_bwd=wk.walk_bwd.launches, **rconv_counts())
    bn_launches = bn_counts()
    losses = [float(m["loss"]) for m in metrics]
    walks = 0 if teacher_student else n_steps
    want = dict(walk_fwd=walks, walk_bwd=walks,
                **{k: v * n_steps for k, v in expect.items()})
    tag = (("teacher-student, " if teacher_student else "")
           + ("" if model_type == "scratch" else f"{model_type}, ")
           + f"rconv={rconv!r}, bn_fuse={bn_fuse!r}")
    if launches != want:
        fail(f"{tag}: kernel launches {launches} in {n_steps} steps, want "
             f"{want}")
    bn_per_step = check_bn_counts(tag, bn_launches, n_steps)
    parts = ([float(m[k]) for m in metrics for k in ("crw_loss", "ts_loss")]
             if teacher_student else [])
    if not all(np.isfinite(losses + parts)):
        fail(f"{tag}: non-finite training loss: {losses} {parts}")
    passes = 4 if teacher_student else 3     # + the teacher's forward
    per_image = (bottleneck_fwd_flops_per_image() if model_type == "scratch50"
                 else conv_fwd_flops_per_image())
    flops = passes * per_image * BATCH * CLIP_LEN * N_PATCHES
    res = dict(model="teacher_student" if teacher_student else "crw",
               model_type=model_type,
               rconv=rconv, bn_fuse=bn_fuse, steps=n_steps, step_ms=dt * 1e3,
               clips_per_s=BATCH / dt, tflop_per_step=flops / 1e12,
               mfu=flops / dt / BF16_PEAK,
               max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               losses=losses, launches=launches,
               launches_per_step={k: v / n_steps for k, v in launches.items()},
               bn_launches_per_step=bn_per_step, state_step=state.step,
               acc_last={k: float(v) for k, v in metrics[-1].items()
                         if k.startswith("acc")})
    if teacher_student:
        res["crw_loss_last"] = float(metrics[-1]["crw_loss"])
        res["ts_loss_last"] = float(metrics[-1]["ts_loss"])
    print(f"training step {tag}, bench.py config (batch {BATCH}, {CLIP_LEN} "
          f"frames, {N_PATCHES}x{PATCH}px patches, bf16 trunk): "
          f"{res['step_ms']:.2f} ms/step over {n_steps} steps, "
          f"{res['clips_per_s']:.2f} clips/s, {res['tflop_per_step']:.2f} "
          f"TFLOP/step (analytic convs), MFU {100 * res['mfu']:.2f}% of "
          f"{BF16_PEAK / 1e12:.0f} TFLOP/s bf16; peak memory "
          f"{res['max_memory_gib']:.2f} GiB; losses {losses[0]:.4f} .. "
          f"{losses[-1]:.4f}; launches per step {res['launches_per_step']}; "
          f"BN launches per step {bn_per_step}", flush=True)
    if profile:   # 3 more steps, after the path's counts were read
        res["profile"] = profile_steps(lambda: step(state, batch, gen))
    if teacher_student:
        moved = [k for k, v in model.teacher.state_dict().items()
                 if not torch.equal(v.cpu(), teacher0[k])]
        if moved:
            fail(f"{tag}: the frozen teacher moved: {moved[:5]}")
        res["teacher_tensors_unchanged"] = len(teacher0)
    del state, batch, model
    torch.cuda.empty_cache()
    return res


def train_step_phase(n_steps: int) -> dict:
    """Phase 6: the flagship training step in four arms that differ only
    by the reflect-conv route, one after another in this process: the cuDNN
    path (``rconv='off'``), the moment fold alone (``auto`` + ``stats``),
    the default (``auto`` + ``auto``: the BN-input chain; profiled) and
    neither (``on`` + ``off``: #4). The default takes ``n_steps`` timed
    steps, the others at most 5."""
    arms = {}
    for (rconv, bn_fuse), expect in ARMS:
        default = (rconv, bn_fuse) == DEFAULT_ARM
        arms[f"{rconv}+{bn_fuse}"] = train_arm(
            rconv, bn_fuse, expect, n_steps if default else min(n_steps, 5),
            profile=default)
    print("A/B of the full step (same process, same seeds):", flush=True)
    for name, a in arms.items():
        print(f"  {name:12s} {a['step_ms']:8.2f} ms/step  "
              f"{a['clips_per_s']:6.2f} clips/s  MFU {100 * a['mfu']:5.2f}%  "
              f"{a['max_memory_gib']:6.2f} GiB", flush=True)
    return arms


def _grad_rel_l2(got: dict, want: dict) -> float:
    """Relative L2 distance of two gradient sets, over all parameters."""
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum())
              for k in want)
    return (num / sum(float((want[k].double() ** 2).sum())
                      for k in want)) ** 0.5


def small_step_card_vs_cpu(model_type: str = "scratch",
                           expect: dict | None = None,
                           f64_reference: bool = False,
                           state: dict | None = None) -> dict:
    """Phase 7: one f32 forward/backward with every supported reflect conv
    routed and every block on the BN-input chain (the default routes; a
    ``scratch50`` trunk's Bottlenecks take #5 and no chain, ``expect``),
    card (kernels) vs CPU
    (plain versions), same weights, same 64 px clips, same edge-drop masks.
    Tolerances: loss rtol 1e-4 and q atol 1e-4 (f32 convolutions by
    different algorithms); gradients 2e-2 relative in L2 over all
    parameters (the early layers' f32 gradients are badly conditioned at
    random weights; the CPU tests measure the same spread against JAX and
    f64).

    ``f64_reference``: the same step also in f64 on the CPU, and the
    gradient bound is the card's distance to those f64 gradients: 2e-2, or
    1.5x the CPU's own f32 distance to them where that is larger. (The
    ``scratch50`` trunk's f32 gradients at these weights are 2.4e-2 from
    f64 on the CPU alone, so no f32 evaluation meets 2e-2 against
    another.)

    ``state``: a ``state_dict`` (a trained checkpoint's weights and BN
    running statistics) loaded over the seeded init on both devices."""
    B, T, N = 2, 4, 4
    cfg = CRWConfig(model_type=model_type, temperature=WALK_TEMP)
    expect = dict(ARMS)[DEFAULT_ARM] if expect is None else expect
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(B, T, N, PATCH, PATCH, 3).astype(np.float32))
    masks = [torch.from_numpy(rng.rand(B, T - 1, N, N) < EDGEDROP)
             for _ in range(2)]
    out = {}
    before = (wk.walk_fwd.launches, wk.walk_bwd.launches, rconv_counts())
    runs = (("cuda", torch.float32), ("cpu", torch.float32)) + (
        (("cpu64", torch.float64),) if f64_reference else ())
    for name, dtype in runs:
        dev = torch.device(name.removesuffix("64"))
        model = seeded_crw(dataclasses.replace(cfg, dtype=dtype), seed=3,
                           state=state).to(dev, dtype)
        q, loss, _ = model(x.to(dev, dtype), train=True,
                           walk_masks=[m.to(dev) for m in masks])
        loss.backward()
        out[name] = (q.detach().cpu(), float(loss.detach()),
                     {k: p.grad.cpu() for k, p in model.named_parameters()})
        if name == "cuda":
            launched = dict(
                walk_fwd=wk.walk_fwd.launches - before[0],
                walk_bwd=wk.walk_bwd.launches - before[1],
                **{k: v - before[2][k] for k, v in rconv_counts().items()})
    wk.walk_fwd.launches, wk.walk_bwd.launches = before[:2]  # not the path's
    set_rconv_counts(before[2])
    (qc, lc, gc), (qh, lh, gh) = out["cuda"], out["cpu"]
    res = dict(loss_cuda=lc, loss_cpu=lh, loss_rel=abs(lc - lh) / abs(lh),
               q_max_abs_err=float((qc - qh).abs().max()),
               grad_rel_l2=_grad_rel_l2(gc, gh), kernel_launches=launched)
    grad_ok = res["grad_rel_l2"] <= 2e-2
    bound = "grads 2e-2"
    if f64_reference:
        g64 = out["cpu64"][2]
        res.update(card_vs_f64=_grad_rel_l2(gc, g64),
                   cpu_vs_f64=_grad_rel_l2(gh, g64))
        res["f64_bound"] = max(2e-2, 1.5 * res["cpu_vs_f64"])
        grad_ok = res["card_vs_f64"] <= res["f64_bound"]
        bound = (f"grads to f64: card {res['card_vs_f64']:.2e}, the CPU's "
                 f"f32 {res['cpu_vs_f64']:.2e}, bound "
                 f"{res['f64_bound']:.2e}")
    print(f"small f32 {model_type} step (B,T,N)=({B},{T},{N}) {PATCH}px, "
          f"{'trained' if state else 'seeded'} weights, default routes, card "
          f"vs CPU: loss {lc:.6f} vs {lh:.6f} (rel {res['loss_rel']:.2e}), q "
          f"max|d| {res['q_max_abs_err']:.2e}, grads rel L2 "
          f"{res['grad_rel_l2']:.2e} (tolerance: loss rtol 1e-4, q 1e-4, "
          f"{bound}); kernel launches on the card {launched}", flush=True)
    if launched != dict(walk_fwd=1, walk_bwd=1, **expect):
        fail(f"the card's small {model_type} step did not go through the "
             f"walk and the reflect-conv kernels")
    if not (res["loss_rel"] <= 1e-4 and res["q_max_abs_err"] <= 1e-4
            and grad_ok):
        fail(f"card and CPU {model_type} training steps disagree")
    return res


def ts_train_phase(n_steps: int) -> dict:
    """The teacher-student flagship step (default routes; profiled), then
    the plain CRW flagship step on the default routes in the same process
    (no profile), both with ``n_steps`` timed steps."""
    ts = train_arm(*DEFAULT_ARM, TS_LAUNCHES, n_steps, profile=True,
                   teacher_student=True)
    plain = train_arm(*DEFAULT_ARM, dict(ARMS)[DEFAULT_ARM], n_steps)
    print("teacher-student vs plain CRW flagship step (same process, default "
          "routes):", flush=True)
    for name, a in (("teacher-student", ts), ("plain CRW", plain)):
        print(f"  {name:16s} {a['step_ms']:8.2f} ms/step  "
              f"{a['clips_per_s']:6.2f} clips/s  MFU {100 * a['mfu']:5.2f}%  "
              f"{a['max_memory_gib']:6.2f} GiB", flush=True)
    return dict(teacher_student=ts, plain=plain)


def _card_vs_cpu(build, x, masks, grads: bool) -> dict:
    """``build()`` (a model seeded on the CPU) run in train mode on the card
    and on the CPU with the same clips and walk masks: q, loss, diagnostics
    and, with ``grads``, the gradients of the parameters that got one."""
    out = {}
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        model = build().to(dev)
        q, loss, diags = model(x.to(dev), train=True,
                               walk_masks=[m.to(dev) for m in masks])
        if grads:
            loss.backward()
        out[name] = dict(
            q=q.detach().cpu(), loss=float(loss.detach()),
            diags={k: float(v.detach()) for k, v in diags.items()},
            grads={k: p.grad.cpu() for k, p in model.named_parameters()
                   if p.grad is not None})
    return out


def small_ts_step_card_vs_cpu() -> dict:
    """One small f32 teacher-student forward/backward (the default routes,
    64 px patches) on the card (kernels) against the CPU (plain versions),
    same weights, clips and student edge-drop masks, with
    ``small_step_card_vs_cpu``'s tolerances (loss rtol 1e-4, q atol 1e-4,
    student gradients 2e-2 relative in L2); the teacher gets no gradient.
    Then one small ``sk_targets`` CRW loss (the experimental Sinkhorn-Knopp
    targets) card vs CPU: loss and diagnostics rtol 1e-4, q atol 1e-4."""
    B, T, N = 2, 4, 4
    cfg = CRWConfig(model_type="scratch", temperature=WALK_TEMP)
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(B, T, N, PATCH, PATCH, 3).astype(np.float32))
    masks = [torch.from_numpy(rng.rand(B, T - 1, N, N) < EDGEDROP)
             for _ in range(2)]
    before = sp_counts()
    out = _card_vs_cpu(lambda: seeded_ts(cfg, seed=3, teacher_seed=4), x,
                       masks, grads=True)
    launched = {k: v - before[k] for k, v in sp_counts().items()}
    set_sp_counts(before)                       # not the path's
    c, h = out["cuda"], out["cpu"]
    num = sum(float(((c["grads"][k] - g) ** 2).sum())
              for k, g in h["grads"].items())
    den = sum(float((g ** 2).sum()) for g in h["grads"].values())
    teacher_grads = [k for k in list(c["grads"]) + list(h["grads"])
                     if k.startswith("teacher.")]
    res = dict(loss_cuda=c["loss"], loss_cpu=h["loss"],
               loss_rel=abs(c["loss"] - h["loss"]) / abs(h["loss"]),
               q_max_abs_err=float((c["q"] - h["q"]).abs().max()),
               grad_rel_l2=(num / den) ** 0.5, kernel_launches=launched)
    print(f"small f32 teacher-student step (B,T,N)=({B},{T},{N}) {PATCH}px, "
          f"default routes, card vs CPU: loss {c['loss']:.6f} vs "
          f"{h['loss']:.6f} (rel {res['loss_rel']:.2e}), q max|d| "
          f"{res['q_max_abs_err']:.2e}, student grads rel L2 "
          f"{res['grad_rel_l2']:.2e} (tolerance: loss rtol 1e-4, q 1e-4, "
          f"grads 2e-2); kernel launches on the card "
          f"{dict((k, v) for k, v in launched.items() if v)}", flush=True)
    if launched != dict(dilate_l1=0, slic_fused=0, walk_fwd=0, walk_bwd=0,
                        **TS_LAUNCHES):
        fail("the card's small teacher-student step did not go through #4 "
             "(teacher) and the default route's kernels (student) alone")
    if teacher_grads or set(c["grads"]) != set(h["grads"]):
        fail(f"teacher gradients or gradient sets differ: {teacher_grads[:3]}")
    if not (res["loss_rel"] <= 1e-4 and res["q_max_abs_err"] <= 1e-4
            and res["grad_rel_l2"] <= 2e-2):
        fail("card and CPU teacher-student steps disagree")

    sk_cfg = CRWConfig(model_type="scratch", temperature=WALK_TEMP,
                       sk_targets=True)
    before = sp_counts()
    sk = _card_vs_cpu(lambda: seeded_crw(sk_cfg, seed=5), x, masks,
                      grads=False)
    walk_launches = sum(sp_counts()[k] - before[k]
                        for k in ("walk_fwd", "walk_bwd"))
    set_sp_counts(before)
    c, h = sk["cuda"], sk["cpu"]
    res["sk_targets"] = dict(
        loss_cuda=c["loss"], loss_cpu=h["loss"],
        loss_rel=abs(c["loss"] - h["loss"]) / abs(h["loss"]),
        diag_max_rel=max(abs(c["diags"][k] - v) / max(abs(v), 1e-12)
                         for k, v in h["diags"].items()),
        q_max_abs_err=float((c["q"] - h["q"]).abs().max()),
        walk_launches=walk_launches, diags_cpu=h["diags"])
    r = res["sk_targets"]
    print(f"small f32 sk_targets CRW loss (B,T,N)=({B},{T},{N}), card vs CPU: "
          f"loss {c['loss']:.6f} vs {h['loss']:.6f} (rel {r['loss_rel']:.2e}), "
          f"diagnostics max rel {r['diag_max_rel']:.2e}, q max|d| "
          f"{r['q_max_abs_err']:.2e} (tolerance 1e-4); walk kernel launches "
          f"{walk_launches}", flush=True)
    if walk_launches or set(c["diags"]) != set(h["diags"]) or not (
            r["loss_rel"] <= 1e-4 and r["diag_max_rel"] <= 1e-4
            and r["q_max_abs_err"] <= 1e-4):
        fail("card and CPU sk_targets losses disagree, or the walk kernels ran")
    return res


def structured_frames(B: int, T: int, h: int, w: int, seed: int) -> torch.Tensor:
    """``(B, T, h, w, 3)`` floats in [0, 1] on the card: four colored
    quadrants whose colors drift from frame to frame, two moving squares and
    5% uniform noise (frames with regions, unlike white noise)."""
    rng = np.random.RandomState(seed)
    out = np.zeros((B, T, h, w, 3), np.float32)
    base = np.array([[.9, .1, .1], [.1, .8, .2], [.15, .2, .9], [.9, .85, .1]],
                    np.float32)
    s = max(h // 5, 4)
    for b in range(B):
        for t in range(T):
            cols = np.clip(base + 0.1 * rng.rand(4, 3) + 0.03 * t, 0, 1)
            img = out[b, t]
            img[:h // 2, :w // 2], img[:h // 2, w // 2:] = cols[0], cols[1]
            img[h // 2:, :w // 2], img[h // 2:, w // 2:] = cols[2], cols[3]
            for y0, x0, vy, vx, col in ((h // 5, w // 8, 2, 5, (.5, .5, .5)),
                                        (h // 2, w // 2, -3, -4, (.1, .6, .7))):
                y = int(np.clip(y0 + vy * (t + b), 0, h - s))
                x = int(np.clip(x0 + vx * (t + b), 0, w - s))
                img[y:y + s, x:x + s] = col
    out += rng.rand(*out.shape).astype(np.float32) * 0.05
    return torch.from_numpy(np.clip(out, 0, 1)).cuda()


def noise_frames(seed: int) -> torch.Tensor:
    """White-noise frames of the step of record (the JAX package's
    superpixel benchmark segments ``rand`` frames too)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((SP_BATCH, SP_CLIP, SP_IMG, SP_IMG, 3), generator=g,
                      device="cuda")


def _agree(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a == b).float().mean())


def slic_window_pairs(x: torch.Tensor, n_segments: int, compactness: float,
                      n_iter: int) -> list[int]:
    """(pixel, center) pairs SLIC compares in each of ``n_iter`` rounds on
    ``x``: for each pixel the centers inside its 2S window (all centers for
    a pixel with none), at the centers the plain ``slic`` holds at that
    round (the grid's, then each update's)."""
    H, W = x.shape[-3], x.shape[-2]
    ratio, window = slic_geometry(H, W, n_segments, compactness)
    xb = x.reshape(-1, H, W, 3)
    B = xb.shape[0]
    centers = initial_centers(rgb_to_lab(xb).reshape(B, H * W, 3), H, W,
                              n_segments, ratio)
    py = torch.arange(H, device=x.device, dtype=torch.float32) * ratio
    px = torch.arange(W, device=x.device, dtype=torch.float32) * ratio
    pairs = []
    for r in range(n_iter):
        in_y = ~((py[None, :, None] - centers[:, None, :, 3]).abs() > window)
        in_x = ~((px[None, :, None] - centers[:, None, :, 4]).abs() > window)
        n = (in_y[:, :, None, :] & in_x[:, None, :, :]).sum(-1)  # (B, H, W)
        pairs.append(int(torch.where(n > 0, n, n_segments).sum()))
        if r + 1 < n_iter:
            _, centers = slic(xb, n_segments, compactness, n_iter=1,
                              init_centers=centers, return_centers=True)
    return pairs


def call_profile(fn, n: int = 10) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``: each kernel's device
    µs a call (SLIC's by their names), the device launches a call and the
    host-to-device copies a call. The profiler may drop the first kernel of
    its window (seen on the card: 10.8 launches a call for 11), so a
    kernel's count a call is rounded and its µs a call is its mean a launch
    times that count."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us, launches, htod = {}, 0, 0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        key, per_call = e.key.lower(), max(round(e.count / n), 1)
        if "memcpy" in key and "htod" in key:
            htod += e.count
        elif "memcpy" not in key and "memset" not in key:
            launches += per_call
        name = re.sub(r"^.*?(slic_\w+).*$", r"\1", e.key)[:60]
        us[name] = us.get(name, 0.0) + t / e.count * per_call
    return dict(kernel_us=us, device_launches=launches, htod_copies=htod / n)


def slic_kernel_vs_plain() -> dict:
    """The fused SLIC kernels (#12) against the plain ``slic`` at the step
    of record, (6, 4, 256, 256, 3) frames, 36 segments, compactness 50, 10
    rounds. The kernel sums ``(f - c)^2`` directly, the plain version
    expands it (terms of ~1e5 that cancel to a few units), so near-ties may
    fall differently and k-means carries a differing pixel through its
    rounds. Checks: (a) one assignment from the same centers (the plain
    version's after 9 rounds), >= 99.9% equal labels, on white-noise and on
    structured frames; (b) the full 10 rounds on structured frames >= 99%;
    a run with ``n_active`` drawn in [30, 42) of 48 slots (no label reaches
    its frame's count; >= 99% on structured frames); two kernel runs bitwise
    equal. ``max_abs_err``: the centers after one round from the grid,
    kernel against plain, on the white-noise frames.

    ``bound_ms``: the rounds' (pixel, center in its window) pairs
    (``slic_window_pairs``, the white-noise frames) x 14 f32 operations
    plus 6 a pixel for each center update, over the f32 peak, against the
    images read and the labels written once over the HBM rate; the old
    count of every (pixel, active center) pair is kept as ``dense_gflop``.
    A call's device launches (``device_launches``) and its SLIC kernels'
    device µs come from ``torch.profiler``; a call must copy nothing from
    the host."""
    before = slic_fused.launches
    kw = dict(n_segments=NUM_SP, compactness=COMPACTNESS)
    frames = dict(noise=noise_frames(seed=11),
                  structured=structured_frames(SP_BATCH, SP_CLIP, SP_IMG,
                                               SP_IMG, seed=12))
    res = dict(one_assignment={}, full_run={})
    for name, x in frames.items():
        _, centers = slic(x, n_iter=SLIC_ITERS - 1, return_centers=True, **kw)
        want = slic(x, n_iter=1, init_centers=centers, **kw)
        got = slic_fused(x, n_iter=1, init_centers=centers, **kw)
        res["one_assignment"][name] = _agree(got, want)
        full_want, full_got = slic(x, **kw), slic_fused(x, **kw)
        if not torch.equal(full_want, want):
            fail("slic: 10 rounds differ from 9 rounds + one assignment")
        res["full_run"][name] = _agree(full_got, full_want)
        if (full_got.dtype != torch.int32 or full_got.shape != x.shape[:-1]
                or int(full_got.min()) < 0 or int(full_got.max()) >= NUM_SP):
            fail(f"slic_fused: bad labels on the {name} frames")
    x = frames["structured"]
    n_active = torch.from_numpy(np.random.RandomState(13).randint(
        30, 42, (SP_BATCH, SP_CLIP))).cuda()
    got = slic_fused(x, MAX_SP, COMPACTNESS, n_active=n_active)
    want = slic(x, MAX_SP, COMPACTNESS, n_active=n_active)
    res["n_active"] = dict(
        agree=_agree(got, want),
        below_count=bool((got.flatten(2).amax(-1) < n_active).all()),
        segments_used=[int(v) for v in
                       (got.flatten(2).amax(-1) + 1).flatten()[:6]])
    xn = frames["noise"]
    a, ca = slic_fused(xn, return_centers=True, **kw)
    b, cb = slic_fused(xn, return_centers=True, **kw)
    res["bitwise_repeat"] = bool(torch.equal(a, b) and torch.equal(ca, cb))
    _, c_want = slic(xn, n_iter=1, return_centers=True, **kw)
    _, c_got = slic_fused(xn, n_iter=1, return_centers=True, **kw)
    res["max_abs_err"] = float((c_got - c_want).abs().max())
    torch.cuda.synchronize()
    print(f"slic_fused vs plain slic at {tuple(xn.shape)}, {NUM_SP} segments, "
          f"{SLIC_ITERS} rounds: equal labels after one assignment from the "
          f"same centers {res['one_assignment']} (tolerance >= 0.999), after "
          f"the full run {res['full_run']} (>= 0.99 on the structured "
          f"frames); n_active in [30, 42) of {MAX_SP}: {res['n_active']}; two "
          f"runs bitwise equal: {res['bitwise_repeat']}; centers after one "
          f"round max|d| {res['max_abs_err']:.3e}", flush=True)
    if not (min(res["one_assignment"].values()) >= 0.999
            and res["full_run"]["structured"] >= 0.99
            and res["n_active"]["agree"] >= 0.99
            and res["n_active"]["below_count"] and res["bitwise_repeat"]
            and res["max_abs_err"] <= 1e-2):
        fail(f"slic_fused disagrees with the plain slic: {res}")
    res["ms"] = cuda_ms(lambda: slic_fused(xn, **kw), 20)
    res["plain_ms"] = cuda_ms(lambda: slic(xn, **kw), 3, 1)
    res["structured_ms"] = cuda_ms(lambda: slic_fused(x, **kw), 20)
    prof = call_profile(lambda: slic_fused(xn, **kw))
    prof_rc = call_profile(
        lambda: slic_fused(xn, return_centers=True, **kw))
    slic_fused.launches = before            # comparison launches do not count
    res.update(profile=prof, profile_return_centers=prof_rc)
    print(f"  one call on white noise, device µs by kernel "
          f"{ {k: round(v, 2) for k, v in prof['kernel_us'].items()} }, "
          f"{prof['device_launches']:g} device launches, "
          f"{prof['htod_copies']:g} host-to-device copies; with "
          f"return_centers {prof_rc['device_launches']:g} launches",
          flush=True)
    if prof["htod_copies"] or prof_rc["htod_copies"]:
        fail(f"slic_fused copies from the host: {prof}")
    if (prof["device_launches"] != device_launches(SLIC_ITERS)
            or prof_rc["device_launches"]
            != device_launches(SLIC_ITERS, return_centers=True)):
        fail(f"slic_fused device launches {prof['device_launches']}, "
             f"{prof_rc['device_launches']}")
    n_pix = SP_BATCH * SP_CLIP * SP_IMG * SP_IMG
    pairs = slic_window_pairs(xn, NUM_SP, COMPACTNESS, SLIC_ITERS)
    update_flops = (SLIC_ITERS - 1) * n_pix * SLIC_UPDATE_FLOPS
    flops = sum(pairs) * SLIC_PAIR_FLOPS + update_flops
    dense = SLIC_ITERS * n_pix * NUM_SP * SLIC_PAIR_FLOPS + update_flops
    nbytes = n_pix * (3 * 4 + 4)
    o_ms, b_ms = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    res.update(gflop=flops / 1e9, dense_gflop=dense / 1e9, bytes=nbytes,
               window_centers_per_pixel=[p / n_pix for p in pairs],
               bound_ms=max(o_ms, b_ms),
               bound_by="operations" if o_ms >= b_ms else "bytes",
               device_launches=prof["device_launches"])
    print(f"  slic_fused {res['ms']:.3f} ms a call on white noise "
          f"({res['structured_ms']:.3f} on the structured frames; "
          f"{res['device_launches']:g} device launches), plain slic "
          f"{res['plain_ms']:.3f} ms; bound {res['bound_ms']:.4f} ms by "
          f"{res['bound_by']} ({res['gflop']:.2f} GFLOP f32 for the "
          f"in-window pairs, centers a pixel by round "
          f"{[round(v, 2) for v in res['window_centers_per_pixel']]}; "
          f"dense_gflop {res['dense_gflop']:.2f} for every pair; "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return res


def superpixel_onehots(x: torch.Tensor) -> torch.Tensor:
    """``(B*T*MAX_SP, h, w)`` bf16 one-hot masks of the SLIC labels of
    ``x``, as ``superpixel_pool_weights`` hands them to the dilation."""
    before = slic_fused.launches
    labels = slic_fused(x, NUM_SP, COMPACTNESS)
    slic_fused.launches = before
    slots = torch.arange(MAX_SP, device="cuda")
    onehot = (labels[:, :, None] == slots[:, None, None]).to(torch.bfloat16)
    return onehot.reshape(-1, *labels.shape[-2:])


# limits of a BN pass against its plain version on the same card tensors
# (tests/test_torch_bn_act_kernel.py's): the forward, the identity's dr and
# the fold bitwise (the same rounded f32 operations); the apply pass one
# bf16 ulp of each entry plus 1e-4 (a fused multiply-add); each f32 sum
# 1e-5 of its channel's sum of magnitudes (another order of addition)
BN_ULP, BN_APPLY_ATOL, BN_SUM_RTOL = 2.0 ** -7, 1e-4, 1e-5


def _bn_act_tensor(gen, shape, nchw, scale=1.0, shift=0.0) -> torch.Tensor:
    t = (torch.randn(shape, generator=gen, device="cuda") * scale
         + shift).to(torch.bfloat16)
    return t if nchw else t.contiguous(memory_format=torch.channels_last)


def bn_passes_vs_plain(case: str, shape: tuple, nchw: bool, seed: int
                       ) -> dict:
    """Each BN pass wrapper (``ops/bn_act.py``: ``bn_moments``,
    ``bn_act_fwd``, ``bn_act_reduce_bwd``, ``bn_act_apply_bwd``,
    ``bn_fold``) against its plain version (``moments_plain``,
    ``act_fwd_plain``, ``act_reduce_bwd_plain``, ``act_apply_bwd_plain``,
    ``fold_plain``: PyTorch on the same card tensors), bf16 of ``shape``,
    in every mode the trunk uses, held to the ``BN_*`` limits. The
    backward's gate is the forward's real output. Returns each comparison's
    max_abs_err (a sum's: its largest error over the limit's scale)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    C = shape[1]
    y = _bn_act_tensor(gen, shape, nchw, 2.0, 0.5)
    yd = _bn_act_tensor(gen, shape, nchw, 1.5, -0.3)
    go = _bn_act_tensor(gen, shape, nchw)
    prm = torch.randn((6, C), generator=gen, device="cuda")
    prm[1] = prm[1].abs() + 0.5
    prm[4] = prm[4].abs() + 0.5
    errs, faults = {}, []

    def exact(name, got, want):
        errs[name] = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            faults.append(f"{name}: max|d| {errs[name]:.3e}, want bitwise")

    def sums(name, got, want, scale):
        ratio = (got - want).abs() / scale.clamp_min(1e-30)
        errs[name] = float((got - want).abs().max())
        errs[name + ".rel"] = float(ratio.max())
        if errs[name + ".rel"] > BN_SUM_RTOL:
            faults.append(f"{name}: {errs[name + '.rel']:.3e} of the sum of "
                          f"magnitudes, limit {BN_SUM_RTOL}")

    def apply(name, got, want):
        err = (got.float() - want.float()).abs()
        errs[name] = float(err.max())
        bad = int((err > BN_ULP * want.float().abs() + BN_APPLY_ATOL).sum())
        if bad:
            faults.append(f"{name}: {bad} entries past one ulp + "
                          f"{BN_APPLY_ATOL}, max|d| {errs[name]:.3e}")

    yf, ydf = ba._wide(y), ba._wide(yd)
    s = ba.bn_moments(y)
    p = ba.moments_plain(y)
    mags = (yf.abs().sum((0, 2, 3)), (yf * yf).sum((0, 2, 3)))
    for k, name in enumerate(("moments.s1", "moments.s2")):
        sums(name, s[k], p[k], mags[k])
    del s, p, mags
    out = None
    for mode, relu, tag in ((ba.PLAIN, True, "plain"),
                            (ba.IDENTITY, True, "identity"),
                            (ba.PROJ, False, "projection_norelu"),
                            (ba.PROJ, True, "projection")):
        sc = None if mode == ba.PLAIN else yd
        pm = prm if mode == ba.PROJ else prm[:3]
        out = ba.bn_act_fwd(y, pm, sc, mode, relu)
        exact(f"fwd.{tag}", out, ba.act_fwd_plain(y, pm, sc, mode, relu))
        means = prm[[0, 3]] if mode == ba.PROJ else prm[:1]
        ydm = yd if mode == ba.PROJ else None
        got, dr = ba.bn_act_reduce_bwd(go, out, y, ydm, means, mode, relu)
        want, pdr = ba.act_reduce_bwd_plain(go, out, y, ydm, means, mode,
                                            relu)
        g = ba._gated(go, out, relu).abs()
        scale = [g.sum((0, 2, 3)),
                 (g * (yf - means[0][None, :, None, None]).abs()).sum((0, 2, 3))]
        if mode == ba.PROJ:
            scale.append((g * (ydf - means[1][None, :, None, None]).abs())
                         .sum((0, 2, 3)))
        sums(f"reduce_bwd.{tag}", got, want, torch.stack(scale))
        del g, scale, got, want
        if mode == ba.IDENTITY:
            exact("reduce_bwd.identity.dr", dr, pdr)
            dy, _ = ba.bn_act_apply_bwd(dr, out, y, None, pm, ba.PLAIN, False)
            pdy, _ = ba.act_apply_bwd_plain(dr, out, y, None, pm, ba.PLAIN,
                                            False)
            apply("apply_bwd.identity.dy", dy, pdy)
        else:
            dy, dyd = ba.bn_act_apply_bwd(go, out, y, ydm, pm, mode, relu)
            pdy, pdyd = ba.act_apply_bwd_plain(go, out, y, ydm, pm, mode,
                                               relu)
            apply(f"apply_bwd.{tag}.dy", dy, pdy)
            if mode == ba.PROJ:
                apply(f"apply_bwd.{tag}.dyd", dyd, pdyd)
        del dr, pdr, dy, pdy
    exact("fold", ba.bn_fold(go, prm[4], prm[5], y),
          ba.fold_plain(go, prm[4], prm[5], y))
    print(f"bn passes vs plain, {case} {shape} "
          f"{'NCHW' if nchw else 'channels_last'}: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    if faults:
        fail(f"bn passes vs plain at {case} {shape}: " + "; ".join(faults))
    return errs


def bn_kernels_vs_plain() -> dict:
    """The BN kernels (``ops/bn_act.py``, ``csrc/bn_act.cu``): each pass
    against its plain version on the same card tensors
    (``bn_passes_vs_plain``) at the flagship's layer4 (12,544 images of
    8x8x512, bf16, channels_last) and at the superpixel step's 64x64 layer1
    (640 x 64 x 64 x 64, NCHW); at layer4 each pass's device ms beside the
    least time its tensors' bytes take at the card's bandwidth (each input
    read once, each output written once); then one BN with its add and
    ReLU forward and backward on the kernels and on the eager chain, with
    the identity and with a projection, at both shapes. The whole BN's
    results are held to the chain's by ``tests/test_torch_bn_act_kernel.py``;
    here only its times."""
    from videowalk_tpu_torch.models.resnet import BatchNorm

    res = dict(vs_plain=dict(
        layer4=bn_passes_vs_plain("layer4", (12544, 512, 8, 8), False, 5),
        sp_layer1=bn_passes_vs_plain("sp_layer1", (640, 64, 64, 64), True,
                                     6)), passes={}, whole={})
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def act(shape, nchw, scale=1.0, shift=0.0):
        return _bn_act_tensor(gen, shape, nchw, scale, shift)

    def bns(C):
        out = []
        for _ in range(2):
            m = BatchNorm(C, torch.bfloat16).cuda()
            with torch.no_grad():
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
            out.append(m)
        return out

    shape = (12544, 512, 8, 8)
    y, r, yd, go = (act(shape, False, 2.0, 0.5), act(shape, False),
                    act(shape, False, 1.5, -0.3), act(shape, False))
    C = shape[1]
    prm = torch.rand((6, C), generator=gen, device="cuda") + 0.5
    out = ba.bn_act_fwd(y, prm[:3], r, ba.IDENTITY, True)
    dr = ba.bn_act_reduce_bwd(go, out, y, None, prm[:1], ba.IDENTITY,
                              True)[1]
    tensor_bytes = y.numel() * y.element_size()
    passes = dict(
        moments=(lambda: ba.bn_moments(y), 1),
        fwd_plain=(lambda: ba.bn_act_fwd(y, prm[:3], None, ba.PLAIN, True), 2),
        fwd_identity=(lambda: ba.bn_act_fwd(y, prm[:3], r, ba.IDENTITY,
                                            True), 3),
        fwd_projection=(lambda: ba.bn_act_fwd(y, prm, yd, ba.PROJ, True), 3),
        reduce_bwd_plain=(lambda: ba.bn_act_reduce_bwd(
            go, out, y, None, prm[:1], ba.PLAIN, True), 3),
        reduce_bwd_identity=(lambda: ba.bn_act_reduce_bwd(
            go, out, y, None, prm[:1], ba.IDENTITY, True), 4),
        reduce_bwd_projection=(lambda: ba.bn_act_reduce_bwd(
            go, out, y, yd, prm[[0, 3]], ba.PROJ, True), 4),
        apply_bwd_plain=(lambda: ba.bn_act_apply_bwd(
            go, out, y, None, prm[:3], ba.PLAIN, True), 4),
        apply_bwd_identity=(lambda: ba.bn_act_apply_bwd(
            dr, out, y, None, prm[:3], ba.PLAIN, False), 3),
        apply_bwd_projection=(lambda: ba.bn_act_apply_bwd(
            go, out, y, yd, prm, ba.PROJ, True), 6),
        fold=(lambda: ba.bn_fold(go, prm[4], prm[5], y), 3))
    for name, (fn, n_tensors) in passes.items():
        ms = cuda_ms(fn, 20)
        bound = n_tensors * tensor_bytes / HBM_RATE * 1e3
        res["passes"][name] = dict(ms=ms, bound_ms=bound,
                                   roofline=bound / ms)
        print(f"bn pass {name} at {shape}: {ms:.3f} ms (bytes bound "
              f"{bound:.3f} ms, {100 * bound / ms:.1f}%)", flush=True)
    del out, dr

    def whole(fn, y, bn, bn_d, kw):
        def run():
            yy = y.detach().requires_grad_()
            extra = {}
            if "shortcut" in kw:
                extra["shortcut"] = kw["shortcut"].detach().requires_grad_()
            if "proj" in kw:
                extra["proj"] = (kw["proj"].detach().requires_grad_(), bn_d)
            fn(yy, bn, None, relu=True, **extra).backward(go_of[id(y)])
        return run

    cases = {"layer4": (shape, False)}
    sp = (640, 64, 64, 64)
    cases["sp_layer1"] = (sp, True)
    for case, (shp, nchw) in cases.items():
        yy = y if case == "layer4" else act(shp, nchw, 2.0, 0.5)
        rr = r if case == "layer4" else act(shp, nchw)
        dd = yd if case == "layer4" else act(shp, nchw, 1.5, -0.3)
        go_of = {id(yy): go if case == "layer4" else act(shp, nchw)}
        bn, bn_d = bns(shp[1])
        for sc, kw in (("identity", dict(shortcut=rr)),
                       ("projection", dict(proj=dd))):
            for path, fn in (("kernels", ba.bn_act_fused),
                             ("chain", ba.bn_act_plain)):
                ms = cuda_ms(whole(fn, yy, bn, bn_d, kw), 5)
                res["whole"][f"{case}.{sc}.{path}"] = ms
            k, c = (res["whole"][f"{case}.{sc}.{p}"]
                    for p in ("kernels", "chain"))
            print(f"bn {case} {sc} forward+backward at {shp}: kernels "
                  f"{k:.3f} ms, eager chain {c:.3f} ms ({c / k:.2f}x)",
                  flush=True)
    return res


def dilation_kernel_vs_plain() -> dict:
    """The L1 dilation kernel (#11) against its plain version (the
    shifted-max decomposition) on the one-hot masks of real SLIC labels at
    the step of record, (1152, 256, 256) bf16, k=55; also k=5 there and a
    ragged (3, 40, 52) f32 stack at k=23. The result is exact 0/1:
    **equality**. Two planted faults must fail the same check: one 64x64
    square of one mask put back to its undilated input, and one row at the
    edge of a kernel band (the last row of the first band) of one mask left
    undilated. ``library_ms``: the reference's formulation, one
    ``F.conv2d`` with the binary diamond kernel, then ``> 0``.
    ``bound_ms``: one read and one write of the stack over the HBM rate;
    the kernel's device µs a call and its device launches a call come from
    ``torch.profiler``, beside the device µs of a ``clone`` of the stack."""
    before = dilate_l1.launches
    x = superpixel_onehots(structured_frames(SP_BATCH, SP_CLIP, SP_IMG, SP_IMG,
                                             seed=12))
    res = dict(shape=tuple(x.shape), differing={})
    got = None
    for k in (DIL_K, 5):
        out = dilate_l1(x, k)
        want = dilate_l1_plain(x, k)
        torch.cuda.synchronize()
        res["differing"][f"k={k}"] = int((out != want).sum())
        if out.dtype != x.dtype or not torch.equal(out, want):
            fail(f"dilate_l1 differs from its plain version at "
                 f"{tuple(x.shape)}, k={k}: {res['differing']}")
        if k == DIL_K:
            got = out
            res["max_abs_err"] = float((out.float() - want.float()).abs().max())
        del want
    small = (torch.rand((3, 40, 52), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
             < 0.01).float()
    res["differing"]["ragged k=23"] = int(
        (dilate_l1(small, 23) != dilate_l1_plain(small, 23)).sum())
    if res["differing"]["ragged k=23"]:
        fail("dilate_l1 differs from its plain version at (3, 40, 52), k=23")
    # planted fault 1: the first 64x64 square that the dilation changed
    changed = (got != x).reshape(x.shape[0], SP_IMG // 64, 64, SP_IMG // 64,
                                 64).any(4).any(2)
    n, ty, tx = (int(v) for v in changed.nonzero()[0])
    faulty = got.clone()
    faulty[n, ty * 64:(ty + 1) * 64, tx * 64:(tx + 1) * 64] = \
        x[n, ty * 64:(ty + 1) * 64, tx * 64:(tx + 1) * 64]
    want = dilate_l1_plain(x, DIL_K)
    res["planted_fault_differing"] = int((faulty != want).sum())
    if torch.equal(faulty, want):
        fail("the dilation check passes a planted fault (a square)")
    # planted fault 2: the last row of the kernel's first band, undilated, in
    # the first mask that the dilation changed there
    edge = choose_band(SP_IMG, SP_IMG, DIL_K // 2) - 1
    n = int((got[:, edge] != x[:, edge]).any(-1).nonzero()[0])
    faulty.copy_(got)
    faulty[n, edge] = x[n, edge]
    res["band_edge_fault"] = dict(mask=n, row=edge,
                                  differing=int((faulty != want).sum()))
    if torch.equal(faulty, want):
        fail("the dilation check passes a planted fault (a band-edge row)")
    res["set_share"] = dict(input=float(x.float().mean()),
                            dilated=float(got.float().mean()))
    del faulty, want
    kernel = make_dilation_kernel(DIL_K, "L1").to(x)[None, None]
    lib = torch.nn.functional.conv2d(x[:48, None], kernel,
                                     padding=DIL_K // 2) > 0
    if not torch.equal(lib[:, 0], got[:48] > 0):
        fail("the conv2d formulation of the dilation disagrees")
    del lib
    res["ms"] = cuda_ms(lambda: dilate_l1(x, DIL_K), 20)
    res["plain_ms"] = cuda_ms(lambda: dilate_l1_plain(x, DIL_K), 3, 1)
    res["library_ms"] = cuda_ms(lambda: torch.nn.functional.conv2d(
        x[:, None], kernel, padding=DIL_K // 2) > 0, 2, 1)
    res["k5_ms"] = cuda_ms(lambda: dilate_l1(x, 5), 20)
    prof = call_profile(lambda: dilate_l1(x, DIL_K))
    res["device_us"] = sum(prof["kernel_us"].values())
    res["device_launches"] = prof["device_launches"]
    # a copy of the stack moves the same bytes: the rate the card reaches
    res["clone_us"] = sum(call_profile(lambda: x.clone())["kernel_us"].values())
    if res["device_launches"] != 1:
        fail(f"dilate_l1 makes {res['device_launches']} device launches a "
             f"call, not 1")
    dilate_l1.launches = before             # comparison launches do not count
    nbytes = 2 * x.numel() * x.element_size()
    res.update(bytes=nbytes, bound_ms=nbytes / HBM_RATE * 1e3,
               bound_by="bytes")
    res["bound_share"] = dict(events=res["bound_ms"] / res["ms"],
                              device=res["bound_ms"] / res["device_us"] * 1e3)
    print(f"dilate_l1 vs plain at {res['shape']} bf16 one-hots of SLIC "
          f"labels: differing pixels {res['differing']} (tolerance: "
          f"equality); planted faults differ in "
          f"{res['planted_fault_differing']} pixels (a 64x64 square "
          f"undilated) and {res['band_edge_fault']['differing']} (row "
          f"{edge}, a band edge, undilated); set share {res['set_share']}",
          flush=True)
    print(f"  dilate_l1 k={DIL_K} {res['ms']:.3f} ms (k=5 {res['k5_ms']:.3f}), "
          f"device {res['device_us']:.1f} us a call in "
          f"{res['device_launches']} device launch(es) (a clone of the "
          f"stack {res['clone_us']:.1f} us), plain "
          f"{res['plain_ms']:.3f} ms, library (conv2d > 0) "
          f"{res['library_ms']:.3f} ms; bound {res['bound_ms']:.4f} ms by "
          f"bytes ({nbytes / 1e6:.0f} MB): {res['bound_share']['events']:.3f}"
          f" of it by events, {res['bound_share']['device']:.3f} by device "
          f"time", flush=True)
    return res


def sp_counts() -> dict:
    return dict(dilate_l1=dilate_l1.launches, slic_fused=slic_fused.launches,
                walk_fwd=wk.walk_fwd.launches, walk_bwd=wk.walk_bwd.launches,
                **rconv_counts())


def set_sp_counts(counts: dict) -> None:
    dilate_l1.launches = counts["dilate_l1"]
    slic_fused.launches = counts["slic_fused"]
    wk.walk_fwd.launches = counts["walk_fwd"]
    wk.walk_bwd.launches = counts["walk_bwd"]
    set_rconv_counts(counts)


# superpixel arms: name -> (nodes, dilate, rconv); every arm is batch 6,
# clips of 4 frames, bf16 trunk, edge dropout 0.1, T 0.05, Adam 3e-4
SP_ARMS = (("sp", ("superpixel", False, "auto")),
           ("sp_dil", ("superpixel", True, "auto")),
           ("sp_dil_rconv_off", ("superpixel", True, "off")),
           ("sp_dil_rconv_on", ("superpixel", True, "on")),
           ("patch", ("patch", False, "auto")))
# reflect-conv launches a step of the superpixel trunk (whole 256 px frames:
# layer2-4 at 32x32, layer1 at 64x64 past the kernels' maps) under
# bn_fuse 'auto', by route: 'auto' and 'on' the 11 stride-1 convs of
# layer2-4 (all but layer2.0.conv1), the 6 conv2 on the chain
SP_LAUNCHES = dict(auto=_launches(fwd_stats=5, dx=5, dw=5, bnin=6),
                   on=_launches(fwd_stats=5, dx=5, dw=5, bnin=6),
                   off=_launches())


def sp_train_arm(name: str, nodes: str, dilate: bool, rconv: str,
                 n_steps: int, n_warmup: int = 3, profile: bool = False,
                 max_sp: int = MAX_SP) -> dict:
    """One arm of the superpixel comparison: seeded init, ``n_warmup``
    steps, then ``n_steps`` timed ones with every kernel count zeroed just
    before and read just after. A superpixel step segments its frames with
    ``slic_fused`` inside the timed step, as the deployed
    ``--sp-backend device`` path does. Per step: ``slic_fused`` 1,
    ``dilate_l1`` 1 with dilation, each walk kernel 1, and the reflect-conv
    kernels as ``SP_LAUNCHES`` states for the route (the patch arm's 8x8
    maps as the flagship's ``ARMS``)."""
    dev = torch.device("cuda")
    sp = nodes == "superpixel"
    cfg = CRWConfig(model_type="scratch", temperature=WALK_TEMP,
                    edgedrop_rate=EDGEDROP, dtype=torch.bfloat16, rconv=rconv,
                    max_sp_num=max_sp, dilate_superpixels=dilate,
                    dilation_kernel_shape="L1", dilation_kernel_size=DIL_K)
    state = create_train_state(seeded_crw(cfg, seed=0),
                               make_optimizer(lr=3e-4), device=dev)
    step = make_train_step()
    gen = torch.Generator(device=dev).manual_seed(1)
    if sp:
        batch = torch.randn((SP_BATCH, SP_CLIP, SP_IMG, SP_IMG, 3),
                            generator=gen, device=dev)
        unnorm = noise_frames(seed=2)       # the [0, 1] view SLIC segments

        def run():
            mask = slic_fused(unnorm, NUM_SP, COMPACTNESS)
            return step(state, batch, gen, sp_mask=mask)
    else:
        batch = torch.randn((SP_BATCH, SP_CLIP, N_PATCHES, PATCH, PATCH, 3),
                            generator=gen, device=dev)

        def run():
            return step(state, batch, gen)
    for _ in range(n_warmup):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    expect = dict(dilate_l1=int(sp and dilate), slic_fused=int(sp),
                  walk_fwd=1, walk_bwd=1,
                  **(SP_LAUNCHES[rconv] if sp else dict(ARMS)[(rconv, "auto")]))
    set_sp_counts(dict.fromkeys(expect, 0))     # counts: this path only
    zero_bn_counts()
    t0 = time.perf_counter()
    metrics = [run() for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_steps
    launches = sp_counts()
    bn_launches = bn_counts()
    losses = [float(m["loss"]) for m in metrics]
    want = {k: v * n_steps for k, v in expect.items()}
    if launches != want:
        fail(f"{name}: kernel launches {launches} in {n_steps} steps, want "
             f"{want}")
    bn_per_step = check_bn_counts(name, bn_launches, n_steps)
    if not all(np.isfinite(losses)):
        fail(f"{name}: non-finite training loss: {losses}")
    res = dict(arm=name, steps=n_steps, step_ms=dt * 1e3,
               clips_per_s=SP_BATCH / dt,
               max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               losses=losses, launches=launches,
               launches_per_step={k: v / n_steps for k, v in launches.items()},
               bn_launches_per_step=bn_per_step,
               acc_last={k: float(v) for k, v in metrics[-1].items()
                         if k.startswith("acc")})
    what = (f"whole {SP_IMG} px frames, SLIC {NUM_SP} in the step"
            + (f", L1 dilation k={DIL_K}" if dilate else "") if sp
            else f"{N_PATCHES}x{PATCH}px patches")
    per_step = {k: v for k, v in res["launches_per_step"].items() if v}
    print(f"training step '{name}' (batch {SP_BATCH}, {SP_CLIP} frames, "
          f"{what}, rconv={rconv!r}, bf16 trunk): {res['step_ms']:.2f} "
          f"ms/step over {n_steps} steps, {res['clips_per_s']:.2f} clips/s; "
          f"peak memory {res['max_memory_gib']:.2f} GiB; losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}; launches per step {per_step}; "
          f"BN launches per step {bn_per_step}", flush=True)
    if profile:   # after the path's counts were read
        res["profile"] = profile_steps(run)
        mask = slic_fused(unnorm, NUM_SP, COMPACTNESS)
        pool = dict(dilate=dilate, dilation_kernel_size=DIL_K)
        res["stages_ms"] = dict(
            slic=cuda_ms(lambda: slic_fused(unnorm, NUM_SP, COMPACTNESS), 10),
            pool_weights=cuda_ms(lambda: superpixel_pool_weights(
                mask, max_sp, (32, 32), **pool), 10),
            pool_weights_undilated=cuda_ms(lambda: superpixel_pool_weights(
                mask, max_sp, (32, 32)), 10))
        res["idle_share_unprofiled"] = \
            1 - res["profile"]["device_ms_per_step"] / res["step_ms"]
        print(f"  stages by CUDA events: {res['stages_ms']}; device busy "
              f"{res['profile']['device_ms_per_step']:.2f} ms of the "
              f"unprofiled {res['step_ms']:.2f} ms/step: idle share "
              f"{res['idle_share_unprofiled']:.3f} (the profiler's own host "
              f"cost inflates the share above)", flush=True)
    del state, batch
    torch.cuda.empty_cache()
    return res


def sp_train_phase(n_steps: int) -> dict:
    """The superpixel training step of record and its comparisons, one
    after another in this process: ``sp`` (no dilation), ``sp_dil`` (L1
    k=55: the headline; ``n_steps`` timed steps, profiled), ``sp_dil`` with
    the reflect convs on cuDNN and with ``rconv='on'`` (the A/B that chose
    ``auto``), and the patch step at the same batch and
    clip length (the reference's reduced-primitive comparison). The others
    take at most 5 timed steps."""
    saved = sp_counts()
    arms = {}
    for name, (nodes, dilate, rconv) in SP_ARMS:
        head = name == "sp_dil"
        arms[name] = sp_train_arm(name, nodes, dilate, rconv,
                                  n_steps if head else min(n_steps, 5),
                                  profile=head)
    set_sp_counts(saved)
    print("superpixel step vs patch step (same process, same seeds):",
          flush=True)
    for name, a in arms.items():
        busy = (f"  device busy {a['profile']['device_ms_per_step']:6.2f} "
                f"ms/step" if "profile" in a else "")
        print(f"  {name:17s} {a['step_ms']:8.2f} ms/step  "
              f"{a['clips_per_s']:6.2f} clips/s  {a['max_memory_gib']:6.2f} "
              f"GiB{busy}", flush=True)
    return arms


def small_sp_step_card_vs_cpu(state: dict | None = None) -> dict:
    """One small f32 superpixel forward/backward (64x64 frames, 12 node
    slots, L1 dilation k=7, the default routes) on the card (kernels)
    against the CPU (plain versions): same weights, frames, edge-drop masks
    and the **same** labels (the card's ``slic_fused``, 9 segments, so
    every frame has absent slots). Tolerances as the small patch step's:
    loss rtol 1e-4, q atol 1e-4, gradients 2e-2 relative in L2. ``state``:
    a ``state_dict`` loaded over the seeded init (``seeded_crw``)."""
    B, T, h, sp_slots = 2, 4, 64, 12
    cfg = CRWConfig(model_type="scratch", temperature=WALK_TEMP,
                    max_sp_num=sp_slots, dilate_superpixels=True,
                    dilation_kernel_size=7)
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(B, T, h, h, 3).astype(np.float32))
    unnorm = torch.from_numpy(rng.rand(B, T, h, h, 3).astype(np.float32))
    masks = [torch.from_numpy(rng.rand(B, T - 1, sp_slots, sp_slots) < EDGEDROP)
             for _ in range(2)]
    before = sp_counts()
    labels = slic_fused(unnorm.cuda(), 9, 30.0)
    out = {}
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        model = seeded_crw(cfg, seed=3, state=state).to(dev)
        q, loss, _ = model(x.to(dev), sp_mask=labels.to(dev), train=True,
                           walk_masks=[m.to(dev) for m in masks])
        loss.backward()
        out[name] = (q.detach().cpu(), float(loss.detach()),
                     {k: p.grad.cpu() for k, p in model.named_parameters()})
    launched = {k: v - before[k] for k, v in sp_counts().items()}
    set_sp_counts(before)                       # not the path's
    (qc, lc, gc), (qh, lh, gh) = out["cuda"], out["cpu"]
    num = sum(float(((gc[k] - gh[k]) ** 2).sum()) for k in gh)
    den = sum(float((gh[k] ** 2).sum()) for k in gh)
    absent = int((qh.abs().amax(1) == 0).sum())
    res = dict(loss_cuda=lc, loss_cpu=lh, loss_rel=abs(lc - lh) / abs(lh),
               q_max_abs_err=float((qc - qh).abs().max()),
               grad_rel_l2=(num / den) ** 0.5, absent_slots=absent,
               kernel_launches=launched)
    print(f"small f32 superpixel step (B,T)=({B},{T}) {h}px, "
          f"{'trained' if state else 'seeded'} weights, {sp_slots} slots "
          f"({absent} of {B * T * sp_slots} absent), L1 dilation k=7, card vs "
          f"CPU: loss {lc:.6f} vs {lh:.6f} (rel {res['loss_rel']:.2e}), q "
          f"max|d| {res['q_max_abs_err']:.2e}, grads rel L2 "
          f"{res['grad_rel_l2']:.2e} (tolerance: loss rtol 1e-4, q 1e-4, "
          f"grads 2e-2); kernel launches on the card "
          f"{dict((k, v) for k, v in launched.items() if v)}", flush=True)
    if launched != dict(dilate_l1=1, slic_fused=1, walk_fwd=1, walk_bwd=1,
                        **dict(ARMS)[DEFAULT_ARM]):
        fail("the card's small superpixel step did not go through the SLIC, "
             "dilation, walk and reflect-conv kernels")
    if absent == 0:
        fail("the small superpixel step has no absent slot")
    if not (res["loss_rel"] <= 1e-4 and res["q_max_abs_err"] <= 1e-4
            and res["grad_rel_l2"] <= 2e-2
            and all(torch.isfinite(g).all() for g in gc.values())):
        fail("card and CPU superpixel steps disagree")
    return res


# the trainer's loop (cli/train.py) over in-memory clips: train.sh's
# config of record (arm a), bench.py's flagship patch loop (b) and
# teacher-student at (b)'s shape (c); raw frames of RawClipTransform's size
RAW = int(SP_IMG * 1.125)
CLI_VIDEOS, CLI_FRAMES = 4, 40
CLI_COMMON = ["--device", "cuda", "--data-path", "in-memory-clips",
              "--frame-aug", "grid", "--dropout", str(EDGEDROP), "--temp",
              str(WALK_TEMP), "--model-type", "scratch", "--lr", "0.0003",
              "--dtype", "bfloat16", "--augs-backend", "device",
              "--workers", "8", "--strict-steps"]
CLI_ARMS = dict(
    # train.sh:10-31: patch and superpixel steps mixed at prob 0.7 (seed 3
    # gives both paths in the 3 warm-up steps and 8 of 20 timed steps)
    config_of_record=CLI_COMMON + [
        "--clip-len", str(SP_CLIP), "--batch-size", str(SP_BATCH),
        "--prob", "0.7", "--sp-method", "slic", "--num-sp", str(NUM_SP),
        "--compactness", str(int(COMPACTNESS)), "--dilate-superpixels",
        "--dilation-kernel-shape", "L1", "--dilation-kernel-size",
        str(DIL_K), "--sp-backend", "device", "--data-parallel",
        "--seed", "3"],
    # bench.py:30-72: batch 8, 8 frames, 7x7 patches of 64 px
    flagship_patch=CLI_COMMON + [
        "--clip-len", str(CLIP_LEN), "--batch-size", str(BATCH),
        "--prob", "1"],
    teacher_student=CLI_COMMON + [
        "--clip-len", str(CLIP_LEN), "--batch-size", str(BATCH),
        "--prob", "1", "--teacher-student", "--alpha-teacher-student",
        str(TS_ALPHA)])


def moving_textures(n_videos: int, n_frames: int, size: int, seed: int
                    ) -> np.ndarray:
    """``(n_videos, n_frames, size, size, 3)`` uint8 clips: seeded
    low-frequency textures (``lowfreq_features``, a 24 px cell) each moving
    by its own few pixels a frame, with a bright square crossing them (the
    objects of ``synthetic_video``)."""
    rng = np.random.RandomState(seed)
    return np.stack([moving_texture(rng, n_frames, size, size)
                     for _ in range(n_videos)])


def moving_texture(rng: np.random.RandomState, n_frames: int, h: int, w: int
                   ) -> np.ndarray:
    """One ``(n_frames, h, w, 3)`` uint8 video of ``moving_textures``."""
    tex = lowfreq_features(rng, 2 * h, 2 * w, 3, cell=24)
    tex = ((tex + 0.5) * 255).clip(0, 255).astype(np.uint8)
    vy, vx = rng.randint(1, 5, 2)
    s = min(h, w) // 6
    out = np.empty((n_frames, h, w, 3), np.uint8)
    for t in range(n_frames):
        y, x = (t * vy) % h, (t * vx) % w
        frame = tex[y:y + h, x:x + w].copy()
        q = (t * 5) % (h - s)
        frame[q:q + s, w // 3:w // 3 + s] = (230, 60, 40)
        out[t] = frame
    return out


class InMemoryClips:
    """``Kinetics400``'s item contract over clips held in memory:
    ``dataset[i] -> ({"raw": (T, RAW, RAW, 3) uint8}, empty sp_mask,
    label)``, every window of ``clip_len`` frames of every video."""

    def __init__(self, videos: np.ndarray, clip_len: int):
        self.videos, self.clip_len = videos, clip_len
        self.per_video = videos.shape[1] - clip_len + 1

    def __len__(self):
        return len(self.videos) * self.per_video

    def __getitem__(self, i: int):
        v, t = divmod(int(i), self.per_video)
        return ({"raw": self.videos[v, t:t + self.clip_len].copy()},
                np.zeros((0,), np.int32), v)


def cli_train_arm(name: str, argv: list, n_warmup: int, n_steps: int,
                  workdir: str, videos: np.ndarray, expect, dataset=None,
                  on_build=None) -> dict:
    """One arm of the trainer's loop: ``train_args(argv)`` as the CLI parses
    it, ``cli.train.build`` with an in-memory dataset (``InMemoryClips`` of
    ``videos`` unless ``dataset(args)`` makes another; its loader and
    prefetcher as the CLI builds them; ``on_build(run)`` may wrap the run's
    step and loader), one epoch of ``n_warmup`` steps
    (writes ``checkpoint.pth``), then a timed epoch of ``n_steps`` with
    every kernel count zeroed just before and read just after.
    ``expect(n_patch, n_sp)`` gives the counts the path must show. Times:
    ms a step by the host clock over the epoch (its end-of-epoch checkpoint
    write left out), and by path from CUDA events recorded after each step
    (an interval covers that step's augmentations, SLIC and step)."""
    from videowalk_tpu_torch.cli import train as cli
    from videowalk_tpu_torch.utils.arguments import (check_supported_train,
                                                     train_args)
    from videowalk_tpu_torch.utils.checkpoint import load_checkpoint

    out = os.path.join(workdir, name)
    args = train_args(argv + ["--output-dir", out, "--logs-dir",
                              os.path.join(out, "logs"),
                              "--steps-per-epoch", str(n_warmup)])
    check_supported_train(args)
    dataset = (InMemoryClips(videos, args.clip_len) if dataset is None
               else dataset(args))
    run = cli.build(args, torch.device("cuda"), dataset)
    if on_build is not None:
        on_build(run)
    marks, real_step = [], run.step

    def step(state, batch, gen, sp_mask=None):
        metrics = real_step(state, batch, gen, sp_mask=sp_mask)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(("sp" if sp_mask is not None else "patch", ev, metrics))
        return metrics

    ck_s, real_ck = [0.0], run.checkpoint_fn

    def checkpoint_fn(state, epoch):
        t = time.perf_counter()
        real_ck(state, epoch)
        ck_s[0] += time.perf_counter() - t

    run.step, run.checkpoint_fn = step, checkpoint_fn
    cli.train_one_epoch(args, run, 0)                   # warm-up
    warm_paths = [m[0] for m in marks]
    marks.clear()
    args.steps_per_epoch = n_steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_sp_counts(dict.fromkeys(sp_counts(), 0))       # counts: this path only
    ck_s[0] = 0.0
    start = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    cli.train_one_epoch(args, run, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - ck_s[0]
    launches = sp_counts()
    paths = [m[0] for m in marks]
    n_sp = paths.count("sp")
    want = expect(n_steps - n_sp, n_sp)
    if launches != want:
        fail(f"train_cli {name}: kernel launches {launches} in {n_steps} "
             f"steps ({n_sp} superpixel), want {want}")
    if len(paths) != n_steps:
        fail(f"train_cli {name}: {len(paths)} steps, want {n_steps}")
    losses = [float(m[2]["loss"]) for m in marks]
    if not all(np.isfinite(losses)):
        fail(f"train_cli {name}: non-finite loss {losses}")
    gaps, prev, intervals = {"patch": [], "sp": []}, start, []
    for path, ev, _ in marks:
        intervals.append(prev.elapsed_time(ev))
        gaps[path].append(intervals[-1])
        prev = ev
    batch = args.batch_size
    res = dict(arm=name, steps=n_steps, warmup_paths=warm_paths, paths=paths,
               steps_by_path={k: len(v) for k, v in gaps.items()},
               step_ms=wall / n_steps * 1e3, clips_per_s=batch * n_steps / wall,
               ms_by_path={k: float(np.mean(v)) if v else None
                           for k, v in gaps.items()},
               interval_ms=intervals, checkpoint_s=ck_s[0],
               state_step=run.state.step,
               max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               losses=losses, launches=launches)
    print(f"train_cli '{name}' (batch {batch}, {args.clip_len} frames, prob "
          f"{args.prob}): {res['step_ms']:.2f} ms/step by the host clock over "
          f"{n_steps} steps ({res['steps_by_path']}), {res['clips_per_s']:.2f} "
          f"clips/s; by path (CUDA events) {res['ms_by_path']}; checkpoint "
          f"write {ck_s[0]:.2f} s left out; peak memory "
          f"{res['max_memory_gib']:.2f} GiB; losses {losses[0]:.4f} .. "
          f"{losses[-1]:.4f}; launches {launches}", flush=True)
    # the epoch's checkpoint.pth holds the state after the timed epoch
    ck_path = os.path.join(args.output_dir, "checkpoint.pth")
    ck = load_checkpoint(ck_path)
    now = run.state.model.state_dict()
    if (ck["epoch"] != 1 or ck["lr_scheduler"]["step"] != run.state.step
            or any(not torch.equal(ck["model"][k], v.cpu())
                   for k, v in now.items())):
        fail(f"train_cli {name}: checkpoint.pth is not the state after the "
             f"timed epoch")
    res["checkpoint"] = dict(path=ck_path, epoch=ck["epoch"],
                             step=ck["lr_scheduler"]["step"])
    del ck
    # the device augmentations alone at this arm's batch (CUDA events),
    # then 5 more steps of the loop under the profiler, no checkpoint
    if args.augs_backend == "device":
        raw = torch.from_numpy(np.stack([dataset[i][0]["raw"] for i in
                                         range(batch)])).cuda()
        res["augs_ms"] = cuda_ms(lambda: cli.train_transform_device(
            raw, run.aug_gen, img_size=args.img_size,
            patch_size=int(args.patch_size[0]), frame_aug=args.frame_aug,
            frame_transforms=args.frame_transforms), 10)
        print(f"  device augs alone {res['augs_ms']:.2f} ms a batch",
              flush=True)
    args.steps_per_epoch, run.checkpoint_fn = 5, None
    res["profile"] = profile_steps(lambda: cli.train_one_epoch(args, run, 2),
                                   n=1, steps_per_run=5)
    print(f"  first interval {intervals[0]:.2f} ms, the others' median "
          f"{float(np.median(intervals[1:])):.2f} ms", flush=True)
    res["_run"], res["_args"] = run, args
    return res


def _want(patch: dict, sp: dict | None = None):
    """Counts of a loop of ``n_patch`` patch and ``n_sp`` superpixel steps:
    ``patch`` and ``sp`` the per-step counts of each path."""
    def want(n_patch, n_sp):
        base = dict.fromkeys(sp_counts(), 0)
        for per, n in ((patch, n_patch), (sp or {}, n_sp)):
            for k, v in per.items():
                base[k] += v * n
        return base
    return want


def train_cli_phase(n_steps: int) -> dict:
    """The trainer on the card, three arms, each beside its bare step
    run in this process: (a) ``train.sh``'s config of record (3 warm-up and
    max(20, n_steps) timed steps, both paths) against the bare ``sp_dil``
    step at 44 node slots and the bare patch step at batch 6; then one
    ``--resume`` step from the ``checkpoint.pth`` (a) wrote, which must
    continue at its step; (b) the flagship patch loop (3 + n_steps) against
    ``train_arm``'s default step; (c) teacher-student at (b)'s shape from a
    seeded CRW teacher written by ``save_checkpoint`` and read by the CLI
    (#4 x15 a step, the teacher bitwise unchanged) against the bare
    teacher-student step."""
    import shutil
    import tempfile

    from videowalk_tpu_torch.cli import train as cli
    from videowalk_tpu_torch.utils.arguments import train_args
    from videowalk_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      save_checkpoint)

    saved = sp_counts()
    workdir = tempfile.mkdtemp(prefix="train_cli_")
    videos = moving_textures(CLI_VIDEOS, CLI_FRAMES, RAW, seed=5)
    walk = dict(walk_fwd=1, walk_bwd=1)
    patch_step = dict(walk, **dict(ARMS)[DEFAULT_ARM])
    sp_step = dict(walk, slic_fused=1, dilate_l1=1, **SP_LAUNCHES["auto"])
    res = {}
    try:
        a = cli_train_arm("config_of_record", CLI_ARMS["config_of_record"], 3,
                          max(20, n_steps), workdir, videos,
                          _want(patch_step, sp_step))
        if not all(a["steps_by_path"].values()):
            fail(f"train_cli config_of_record: a path never ran: {a['paths']}")
        if set(a["warmup_paths"]) != {"patch", "sp"}:
            fail(f"train_cli config_of_record: warm-up took "
                 f"{a['warmup_paths']}, not both paths")
        run, args = a.pop("_run"), a.pop("_args")
        if run.state.model.cfg.max_sp_num != 44:
            fail(f"train.sh's flags give {run.state.model.cfg.max_sp_num} "
                 f"node slots, want 44")
        del run
        torch.cuda.empty_cache()
        ck = a["checkpoint"]
        resumed = cli.main(train_args(
            CLI_ARMS["config_of_record"] + [
                "--output-dir", os.path.join(workdir, "resumed"),
                "--logs-dir", os.path.join(workdir, "resumed", "logs"),
                "--resume", ck["path"], "--epochs", "3",
                "--steps-per-epoch", "1"]),
            dataset=InMemoryClips(videos, SP_CLIP))
        a["resume"] = dict(saved_step=ck["step"], saved_epoch=ck["epoch"],
                           step_after=resumed.step)
        if resumed.step != ck["step"] + 1:
            fail(f"train_cli: --resume from step {ck['step']} ended at step "
                 f"{resumed.step} after one step")
        print(f"train_cli --resume: {a['resume']}", flush=True)
        del resumed
        torch.cuda.empty_cache()
        bare = dict(
            sp_dil=sp_train_arm("sp_dil_44", "superpixel", True, "auto",
                                n_steps, max_sp=44),
            patch=sp_train_arm("patch", "patch", False, "auto", n_steps))
        share = a["steps_by_path"]["sp"] / a["steps"]
        a["bare_ms"] = {k: v["step_ms"] for k, v in bare.items()}
        a["bare_mix_ms"] = (share * bare["sp_dil"]["step_ms"]
                            + (1 - share) * bare["patch"]["step_ms"])
        res["config_of_record"] = a

        b = cli_train_arm("flagship_patch", CLI_ARMS["flagship_patch"], 3,
                          n_steps, workdir, videos, _want(patch_step))
        for k in ("_run", "_args"):
            b.pop(k)
        torch.cuda.empty_cache()
        b["bare_ms"] = train_arm(*DEFAULT_ARM, dict(ARMS)[DEFAULT_ARM],
                                 n_steps)["step_ms"]
        res["flagship_patch"] = b

        cfg = CRWConfig(model_type="scratch", temperature=WALK_TEMP,
                        edgedrop_rate=EDGEDROP, dtype=torch.bfloat16)
        teacher = os.path.join(workdir, "teacher.pth")
        save_checkpoint(teacher, seeded_crw(cfg, seed=2))
        c = cli_train_arm("teacher_student", CLI_ARMS["teacher_student"] + [
            "--path-to-pretrained", teacher], 3, n_steps, workdir, videos,
            _want(TS_LAUNCHES))
        run = c.pop("_run")
        c.pop("_args")
        kept = load_checkpoint(teacher)["model"]
        got = run.state.model.teacher.state_dict()
        moved = [k for k, v in kept.items() if not torch.equal(got[k].cpu(), v)]
        if moved:
            fail(f"train_cli teacher_student: the teacher moved: {moved[:5]}")
        c["teacher_tensors_unchanged"] = len(kept)
        del run
        torch.cuda.empty_cache()
        c["bare_ms"] = train_arm(*DEFAULT_ARM, TS_LAUNCHES, n_steps,
                                 teacher_student=True)["step_ms"]
        res["teacher_student"] = c
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        set_sp_counts(saved)
    print("trainer loop vs bare step (same process):", flush=True)
    for name, r in res.items():
        bare = r.get("bare_mix_ms", r.get("bare_ms"))
        print(f"  {name:17s} loop {r['step_ms']:8.2f} ms/step "
              f"{r['clips_per_s']:6.2f} clips/s; bare {bare:8.2f} ms/step; "
              f"loop overhead {r['step_ms'] - bare:+.2f} ms/step", flush=True)
    return res


# the trainer on host superpixels (--sp-backend host): train.sh's flags with
# the loader's SLIC (arm host_slic) or its per-clip SLIC/FH mix at prob 0.7
# (host_random), beside the same flags with SLIC on the card (device_slic)
HOST_SP_ITEMS = 72                 # 12 batches of 6: outlasts every epoch
HOST_SP_ARGV = ["--sp-backend", "host", "--augs-backend", "host"]
FH_DENSE = dict(scale=0.2, min_size=30)   # ~100 FH ids a frame: past 44
HOST_SP_TRACE = (("rconv_slab", "reflect_conv_"), ("walk_", "walk_"),
                 ("dilate", "dilate_l1"))


class InMemoryViews:
    """``Kinetics400``'s item contract under ``--augs-backend host
    --sp-backend host``, over views made once: ``dataset[i] -> ({"grid",
    "whole", "whole_unnorm"} numpy, host ids, i)``. No file is read and
    no host augmentation runs (``files`` drives both): the views of each
    ``InMemoryClips`` window come from the port's device transform
    (``host_views``); ``__getitem__`` makes the ids as ``Kinetics400`` does,
    with ``data/superpixels.py::host_sp_mask`` and the item's own
    ``RandomState([seed, epoch, i])``, in the loader's threads. The label
    is the item's index, so that a batch's ids can be made again."""

    def __init__(self, views: dict, args, seed: int):
        self.views = views
        self.sp_method, self.sp_backend = args.sp_method, args.sp_backend
        self.num_components, self.prob = args.num_sp, args.prob
        self.randomise_superpixels = args.randomise_superpixels
        self.randomise_superpixels_range = args.randomise_superpixels_range
        self.compactness, self.base_seed, self._epoch = 100, seed, 0

    def __len__(self):
        return len(self.views["whole"])

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def set_compactness(self, compactness) -> None:
        self.compactness = compactness

    def view(self, i: int) -> dict:
        return {k: v[i] for k, v in self.views.items()}

    def rng(self, i: int) -> np.random.RandomState:
        return np.random.RandomState([self.base_seed, self._epoch, int(i)])

    def __getitem__(self, i: int):
        v = self.view(i)
        return v, host_sp_mask(v, self, self.rng(i)), int(i)


def host_views(videos: np.ndarray, n_items: int, seed: int) -> dict:
    """The ``grid``, ``whole`` and ``whole_unnorm`` views of the first
    ``n_items`` ``InMemoryClips`` windows (clips of ``SP_CLIP``) by the
    device transform at ``train.sh``'s flags (crop, 256 px, a grid of 64 px
    patches), a batch at a time on the card, as host numpy arrays."""
    from videowalk_tpu_torch.ops.augs_device import train_transform_device

    clips = InMemoryClips(videos, SP_CLIP)
    gen = torch.Generator("cuda").manual_seed(seed)
    out = {}
    for i0 in range(0, n_items, SP_BATCH):
        raw = torch.from_numpy(np.stack([
            clips[i][0]["raw"] for i in range(i0, min(n_items, i0 + SP_BATCH))
        ])).cuda()
        v = train_transform_device(raw, gen, img_size=SP_IMG,
                                   patch_size=PATCH, frame_aug="grid",
                                   frame_transforms="crop")
        for k in ("grid", "whole", "whole_unnorm"):
            out.setdefault(k, []).append(v[k].cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


class _BatchLog:
    """The run's loader, logging each batch's labels and ids as it yields
    them."""

    def __init__(self, loader):
        self.loader, self.batches = loader, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for item in self.loader:
            self.batches.append((np.asarray(item[2]), item[1]))
            yield item


def dilation_on_ids(ids: torch.Tensor, n_slots: int, tag: str) -> dict:
    """#11 against its plain version on the one-hot of ``ids (B, T, h, w)``
    over ``n_slots`` node slots (an id at or past them sets no slot), as
    ``superpixel_pool_weights`` builds it: equality. Its launch is not
    counted."""
    before = dilate_l1.launches
    slots = torch.arange(n_slots, device=ids.device)
    onehot = (ids[:, :, None] == slots[:, None, None]).to(torch.bfloat16)
    onehot = onehot.reshape(-1, *ids.shape[-2:])
    got, want = dilate_l1(onehot, DIL_K), dilate_l1_plain(onehot, DIL_K)
    dilate_l1.launches = before
    diff = int((got != want).sum())
    res = dict(max_id=int(ids.max()),
               ids_past_slots=int((ids >= n_slots).sum()), differing=diff)
    if diff:
        fail(f"host_sp: #11 differs from its plain version on {diff} "
             f"elements of the {tag} ids")
    return res


def trace_kernels(path: str) -> dict:
    """{kernel name: [device µs of each launch]} of a Chrome trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            out.setdefault(e["name"], []).append(float(e["dur"]))
    return out


def host_frame_ms(frames: np.ndarray) -> dict:
    """Median host ms of one frame of ``compute_sp_slic`` (native) and of
    ``compute_sp_FH`` over ``frames``, with cv2 where it is installed and
    with the port's own normalize, Lab and blur (cv2's handle set to
    None)."""
    from videowalk_tpu_torch.data import superpixels

    real = superpixels._cv2
    res = {}
    for cv2_on in ((True, False) if real() is not None else (False,)):
        if not cv2_on:
            superpixels._cv2 = lambda: None
        try:
            for what, fn in (("slic_native", lambda f: compute_sp_slic(
                    f, NUM_SP, COMPACTNESS)), ("fh", compute_sp_FH)):
                fn(frames[0])
                ts = []
                for f in frames:
                    t = time.perf_counter()
                    fn(f)
                    ts.append((time.perf_counter() - t) * 1e3)
                res[f"{what}_{'cv2' if cv2_on else 'no_cv2'}"] = float(
                    np.median(ts))
        finally:
            superpixels._cv2 = real
    print(f"host_sp: one 256x256 frame on the host (median of {len(frames)}; "
          f"with cv2 where installed, and without): " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in res.items()), flush=True)
    return res


def epoch_paths(seed: int, epoch: int, n: int, prob: float) -> list:
    """The first ``n`` path draws of an epoch as ``cli/train.py`` draws
    them from ``RandomState(seed + epoch)`` (a path, then the checkpoint
    coin, a step; no ``--randomise-superpixels``): True for a patch
    step."""
    rs = np.random.RandomState(seed + epoch)
    paths = []
    for _ in range(n):
        paths.append(bool(rs.choice([True, False], p=[prob, 1 - prob])))
        rs.random_sample()
    return paths


def seed_with_sp_in(steps, prob: float) -> int:
    """The first seed whose epoch-0 path draws take a superpixel step among
    ``steps``."""
    for seed in range(100):
        paths = epoch_paths(seed, 0, max(steps) + 1, prob)
        if not all(paths[i] for i in steps):
            return seed
    fail("no seed takes a superpixel step in the traced window")


def host_sp_phase(n_steps: int, table_ms: dict | None = None) -> dict:
    """Superpixel training from host masks (``--sp-backend host``) through
    the trainer's loop: ``train.sh``'s flags over ``InMemoryViews`` with the
    loader's SLIC (``host_slic``) and its per-clip SLIC/FH mix
    (``host_random``), each 3 warm-up and ``n_steps`` timed steps beside
    the same flags with SLIC on the card (``device_slic``) in this process.
    Checks: each superpixel step got exactly the ids the loader made for
    that batch (found by identity among the logged batches; the first two
    steps' ids made again from the items), #12 launched 0 times and #11
    once a superpixel step, #11 equal to its plain version on those ids and
    on dense FH ids of the same frames (ids past the 44 slots), finite
    losses. Then the host ms of one 256x256 frame of ``compute_sp_slic``
    (native) and ``compute_sp_FH``, and a ``--profile-dir`` run through
    ``main`` whose trace of steps 5-9 must name the hand kernels; each
    one's device time there is printed beside ``table_ms`` (this run's
    kernel line) where given."""
    import shutil

    from videowalk_tpu_torch.cli import train as cli
    from videowalk_tpu_torch.utils.arguments import train_args

    saved = sp_counts()
    workdir = tempfile.mkdtemp(prefix="host_sp_")
    videos = moving_textures(CLI_VIDEOS, CLI_FRAMES, RAW, seed=5)
    t0 = time.perf_counter()
    views = host_views(videos, HOST_SP_ITEMS, seed=6)
    print(f"host_sp: views of {HOST_SP_ITEMS} clips made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    walk = dict(walk_fwd=1, walk_bwd=1)
    patch_step = dict(walk, **dict(ARMS)[DEFAULT_ARM])
    host_step = dict(walk, dilate_l1=1, **SP_LAUNCHES["auto"])
    res = {}
    try:
        a = cli_train_arm("device_slic", CLI_ARMS["config_of_record"], 3,
                          n_steps, workdir, videos,
                          _want(patch_step, dict(host_step, slic_fused=1)))
        for k in ("_run", "_args"):
            a.pop(k)
        res["device_slic"] = a
        torch.cuda.empty_cache()
        for method in ("slic", "random"):
            name, log = f"host_{method}", {"steps": []}

            def on_build(run, log=log):
                run.loader = log["loader"] = _BatchLog(run.loader)
                real = run.step

                def step(state, batch, gen, sp_mask=None):
                    if sp_mask is not None:
                        log["steps"].append(sp_mask)
                    return real(state, batch, gen, sp_mask=sp_mask)
                run.step = step

            r = cli_train_arm(
                name, CLI_ARMS["config_of_record"] + HOST_SP_ARGV + [
                    "--sp-method", method], 3, n_steps, workdir, videos,
                _want(patch_step, host_step),
                dataset=lambda args: InMemoryViews(views, args, seed=7),
                on_build=on_build)
            run = r.pop("_run")
            r.pop("_args")
            ds = run.dataset
            if not r["steps_by_path"]["sp"]:
                fail(f"host_sp {name}: no superpixel step in the timed "
                     f"epoch")
            by_id = {id(m): lab for lab, m in log["loader"].batches}
            labels = []
            for m in log["steps"]:
                if id(m) not in by_id:
                    fail(f"host_sp {name}: a superpixel step got ids that "
                         f"no loader batch carried")
                labels.append(by_id[id(m)])
            for m, lab in list(zip(log["steps"], labels))[:2]:
                want = np.stack([host_sp_mask(ds.view(i), ds, ds.rng(i))
                                 for i in lab])
                if not np.array_equal(m.cpu().numpy(), want):
                    fail(f"host_sp {name}: a step's ids differ from the "
                         f"host function's for its batch {lab.tolist()}")
            r["sp_steps_checked"] = len(log["steps"])
            slots = run.state.model.cfg.max_sp_num
            r["dilation_host_ids"] = dilation_on_ids(log["steps"][0], slots,
                                                     name)
            frames = ds.views["whole_unnorm"][labels[0]]
            dense = torch.from_numpy(np.stack([
                [compute_sp_FH(f, **FH_DENSE) for f in clip]
                for clip in frames])).cuda()
            r["dilation_dense_fh_ids"] = dilation_on_ids(dense, slots,
                                                         "dense FH")
            if r["dilation_dense_fh_ids"]["max_id"] < slots:
                fail("host_sp: the dense FH ids do not pass the slots")
            print(f"host_sp {name}: {len(log['steps'])} superpixel steps got "
                  f"the loader's ids; #11 equal to plain on them (max id "
                  f"{r['dilation_host_ids']['max_id']}) and on dense FH ids "
                  f"(max id {r['dilation_dense_fh_ids']['max_id']}, "
                  f"{r['dilation_dense_fh_ids']['ids_past_slots']} pixels "
                  f"past the {slots} slots)", flush=True)
            res[name] = r
            del run, log
            torch.cuda.empty_cache()

        frames = views["whole_unnorm"][:5].reshape(-1, SP_IMG, SP_IMG, 3)
        res["host_ms_per_frame"] = host_frame_ms(frames)

        seed = seed_with_sp_in(range(5, 10), 0.7)
        prof = os.path.join(workdir, "trace")
        args = train_args(CLI_ARMS["config_of_record"] + HOST_SP_ARGV + [
            "--seed", str(seed), "--output-dir", os.path.join(workdir, "p"),
            "--logs-dir", os.path.join(workdir, "p", "logs"),
            "--profile-dir", prof, "--epochs", "1",
            "--steps-per-epoch", "10"])
        cli.main(args, dataset=InMemoryViews(views, args, seed=7))
        if torch.autograd.profiler._is_profiler_enabled:
            fail("host_sp: a profiler is still running after --profile-dir")
        path = os.path.join(prof, "train_epoch0_steps5-9.pt.trace.json")
        kernels = trace_kernels(path)
        shown = {}
        for part, table in HOST_SP_TRACE:
            hits = {k: v for k, v in kernels.items() if part in k}
            if not hits:
                fail(f"host_sp: the trace names no {part} kernel")
            n = sum(len(v) for v in hits.values())
            us = sum(sum(v) for v in hits.values())
            shown[part] = dict(launches=n, device_ms=us / 1e3,
                               ms_per_launch=us / n / 1e3,
                               kernels=sorted((k[:80], len(v), sum(v) / len(v))
                                              for k, v in hits.items()))
            tab = {k: v for k, v in (table_ms or {}).items()
                   if k.startswith(table)}
            print(f"host_sp trace (steps 5-9, seed {seed}): {part}* "
                  f"{n} launches, {us / 1e3:.3f} ms device, "
                  f"{us / n / 1e3:.4f} ms a launch; table (this run, its "
                  f"shapes): " + (", ".join(f"{k} {v:.3f} ms" for k, v in
                                            tab.items()) or "not run"),
                  flush=True)
            for k, c, mean in shown[part]["kernels"]:
                print(f"    {c:4d} x {mean:9.2f} us  {k}", flush=True)
        res["trace"] = dict(path=os.path.basename(path), seed=seed,
                            kernels=shown)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        set_sp_counts(saved)
    print("host superpixels vs SLIC on the card (same process):", flush=True)
    for name in ("device_slic", "host_slic", "host_random"):
        r = res[name]
        pr = r["profile"]
        print(f"  {name:12s} {r['step_ms']:8.2f} ms/step host clock, by path "
              f"(CUDA events) {r['ms_by_path']}; profile: device busy "
              f"{pr['device_ms_per_step']:.2f} ms/step, idle share "
              f"{pr['idle_share']:.3f}", flush=True)
    return res


# the scratch50 trunk's routed 3x3s (conv2 of each Bottleneck but
# layer2.0's, which has stride 2) by stage: 15 a step on #5, #9, #10 under
# the default route (no BN-input chain in a Bottleneck)
R50_ROUTED = dict(layer1=3, layer2=3, layer3=6, layer4=3)
R50_LAUNCHES = _launches(fwd_stats=15, dx=15, dw=15)
R50_EVAL_TARGETS, R50_PLAIN_TARGETS = 20, 8


def remat_arm(stages: str | None, n_steps: int, n_warmup: int = 1) -> tuple:
    """The ``scratch50`` flagship step with ``remat_stages=stages`` (None:
    remat off), seeded as ``train_arm``. Two steps first under cuDNN's
    deterministic algorithms: the first step's loss, gradients and the BN
    running statistics after it, and the second step's loss, are what the
    arms compare. Then (``n_steps`` > 0) ``n_warmup`` steps and ``n_steps``
    timed ones with the counts zeroed just before and read just after: #5
    launches once a routed conv a step and again for each conv a
    rematerialized stage recomputes; #9, #10 and the walk as without remat.
    Returns the numbers, the statistics and the gradients."""
    dev = torch.device("cuda")
    cfg = CRWConfig(model_type="scratch50", temperature=WALK_TEMP,
                    edgedrop_rate=EDGEDROP, dtype=torch.bfloat16,
                    remat=stages is not None, remat_stages=stages)
    model = seeded_crw(cfg, seed=0)
    state = create_train_state(model, make_optimizer(lr=3e-4), device=dev)
    step = make_train_step()
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = torch.randn((BATCH, CLIP_LEN, N_PATCHES, PATCH, PATCH, 3),
                        generator=gen, device=dev)
    torch.backends.cudnn.deterministic = True
    try:
        first = [float(step(state, batch, gen)["loss"])]
        stats = {k: v.clone() for k, v in model.named_buffers()
                 if "running" in k}
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        first.append(float(step(state, batch, gen)["loss"]))
    finally:
        torch.backends.cudnn.deterministic = False
    name = "off" if stages is None else stages
    res = dict(stages=name, first_losses=first)
    if not np.all(np.isfinite(first)):
        fail(f"scratch50 remat {name}: non-finite loss {first}")
    if n_steps:
        for _ in range(n_warmup):
            step(state, batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wk.walk_fwd.launches = wk.walk_bwd.launches = 0
        set_rconv_counts(dict.fromkeys(R50_LAUNCHES, 0))
        t0 = time.perf_counter()
        losses = [float(step(state, batch, gen)["loss"])
                  for _ in range(n_steps)]
        dt = (time.perf_counter() - t0) / n_steps
        launches = dict(walk_fwd=wk.walk_fwd.launches,
                        walk_bwd=wk.walk_bwd.launches, **rconv_counts())
        recomputed = 0 if stages is None else sum(
            R50_ROUTED[s] for s in remat_stage_set(stages))
        want = dict(walk_fwd=n_steps, walk_bwd=n_steps,
                    **{k: v * n_steps for k, v in R50_LAUNCHES.items()})
        want["fwd_stats"] += recomputed * n_steps
        if launches != want:
            fail(f"scratch50 remat {name}: launches {launches} in {n_steps} "
                 f"steps, want {want}")
        if not np.all(np.isfinite(losses)):
            fail(f"scratch50 remat {name}: non-finite loss {losses}")
        res.update(steps=n_steps, step_ms=dt * 1e3, clips_per_s=BATCH / dt,
                   recomputed_convs=recomputed,
                   max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches_per_step={k: v / n_steps
                                      for k, v in launches.items()})
        print(f"scratch50 step, remat {name}: {res['step_ms']:.2f} ms/step "
              f"over {n_steps} steps, peak {res['max_memory_gib']:.2f} GiB; "
              f"#5 {res['launches_per_step']['fwd_stats']:.0f} a step (15 + "
              f"{recomputed} recomputed); first losses {first}", flush=True)
    tracked = {int(v) for k, v in model.named_buffers()
               if k.endswith("num_batches_tracked")}
    if tracked != {state.step}:
        fail(f"scratch50 remat {name}: BN statistics updated {tracked} "
             f"times in {state.step} steps")
    del state, batch, model
    torch.cuda.empty_cache()
    return res, stats, grads


def _rel(a: dict, b: dict) -> float:
    """The largest relative max-difference of ``a``'s tensors to ``b``'s."""
    return max(float((v.double() - b[k].double()).abs().max()
                     / b[k].double().abs().max().clamp_min(1e-30))
               for k, v in a.items())


def remat_arms(n_steps: int) -> dict:
    """Remat off, ``layer1`` and ``all`` on the ``scratch50`` flagship step,
    one after another in this process, and the first two steps of the off
    arm once more. Against the off arm, within 1e-6 relative: the first
    step's loss and the BN running statistics after it (what a recompute
    that updated the statistics again, or computed another forward, would
    move); every BN's update count equals the steps taken (``remat_arm``).
    The first step's gradients within 5e-2 relative in L2: the backward of
    the reflect pads and of the stem's max pool accumulates with atomics on
    the card, and the trunk's BN backward magnifies that order, so two runs
    of one arm part by ~4e-3 (the repeated off arm measures it, and the
    second loss's spread, which those gradients move through Adam); a
    wrong backward parts by O(1)."""
    res, stats, grads = {}, {}, {}
    for stages, n in ((None, n_steps), ("off again", 0), ("layer1", n_steps),
                      ("all", n_steps)):
        name = stages or "off"
        r, stats[name], grads[name] = remat_arm(
            None if stages == "off again" else stages, n)
        res[name] = dict(r, stages=name)
    off = res["off"]
    for name in ("off again", "layer1", "all"):
        r = res[name]
        r.update(
            loss_rel=abs(r["first_losses"][0] - off["first_losses"][0])
            / abs(off["first_losses"][0]),
            bn_stats_rel=_rel(stats[name], stats["off"]),
            grad_rel_l2=_grad_rel_l2(grads[name], grads["off"]),
            second_loss_rel=abs(r["first_losses"][1] - off["first_losses"][1])
            / abs(off["first_losses"][1]))
        print(f"remat {name} vs off: first loss rel {r['loss_rel']:.2e}, BN "
              f"running statistics rel {r['bn_stats_rel']:.2e} (tolerance "
              f"1e-6); first step's gradients rel L2 {r['grad_rel_l2']:.2e} "
              f"(tolerance 5e-2); second loss rel {r['second_loss_rel']:.2e}"
              + (f"; {r['step_ms']:.2f} vs {off['step_ms']:.2f} ms/step, "
                 f"{r['max_memory_gib']:.2f} vs {off['max_memory_gib']:.2f} "
                 f"GiB" if "step_ms" in r else ""), flush=True)
        if not (r["loss_rel"] <= 1e-6 and r["bn_stats_rel"] <= 1e-6
                and r["grad_rel_l2"] <= 5e-2):
            fail(f"remat {name} disagrees with remat off")
    return res


def torchvision_resnet50_state(seed: int) -> dict:
    """A ResNet-50 ``state_dict`` under torchvision's key names, built by
    hand from the port's trunk (no torchvision here) plus the ``fc`` head
    the trunk drops: He-scaled kernels, BN weights near 1, small biases and
    running means, running variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    shapes = {k: tuple(v.shape) for k, v in resnet50().state_dict().items()}
    shapes.update({"fc.weight": (1000, 2048), "fc.bias": (1000,)})
    out = {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.tensor(0, dtype=torch.int64)
            continue
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) > 1:
            v = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("weight"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        out[k] = torch.from_numpy(v.astype(np.float32))
    return out


def resnet50_eval(n_targets: int = R50_EVAL_TARGETS) -> dict:
    """The Eval cell with a ResNet-50: a seeded ``imagenet50`` file written
    to a temporary ``.pth`` and loaded through ``--pretrained-path``
    (``cli.test.build_model``), layer4 removed (C = 1024), the eval video at
    480x854 through ``cli.test.test()``; #1 once a target (its count zeroed
    just before and read just after), then held to its plain version on the
    eval's own features."""
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "imagenet50.pth")
        torch.save(torchvision_resnet50_state(seed=11), path)
        args = eval_args()
        args.model_type, args.pretrained_path = "imagenet50", path
        model = build_model(args, torch.device("cuda"), seed=0)
    if model.spec.hid_dim != 1024:
        fail(f"imagenet50 without layer4: {model.spec.hid_dim} channels")
    imgs, lbls, lblset = synthetic_video(n_targets, 480, 854, seed=1)
    run_eval(model, imgs[:N_CONTEXT + 2], lbls[:N_CONTEXT + 2], lblset)  # warm
    torch.cuda.synchronize()
    ps.prop_sparse.launches = 0                      # counts: main path only
    preds, st = run_eval(model, imgs, lbls, lblset)
    launches = ps.prop_sparse.launches
    if len(preds) != n_targets or launches != n_targets:
        fail(f"ResNet-50 eval: {len(preds)} predictions, {launches} kernel "
             f"launches for {n_targets} targets")
    for p in preds:
        if p.shape != (H, W, 3) or not np.isfinite(p).all():
            fail(f"ResNet-50 eval: bad prediction {p.shape}")
    if not np.array_equal(preds[0], lbls[0]):
        fail("ResNet-50 eval: first target is not the frame-0 ground truth")
    res = dict(channels=1024, frames=st["frames"], targets=st["targets"],
               launches=launches,
               encode_ms_per_frame=st["encode_s"] * 1e3 / st["frames"],
               prop_ms_per_target=st["propagate_s"] * 1e3 / st["targets"],
               e2e_ms_per_frame=st["total_s"] * 1e3 / st["targets"],
               vs_plain=prop_against_plain(
                   model, imgs[:N_CONTEXT + R50_PLAIN_TARGETS],
                   lbls[:N_CONTEXT + R50_PLAIN_TARGETS], R50_PLAIN_TARGETS,
                   "ResNet-50 DAVIS 480x854, C=1024"))
    print(f"ResNet-50 (imagenet50 from --pretrained-path, C=1024) eval "
          f"480x854, {st['frames']} frames ({n_targets} targets): encode "
          f"{res['encode_ms_per_frame']:.2f} ms/frame, propagation "
          f"{res['prop_ms_per_target']:.2f} ms/target, end to end "
          f"{res['e2e_ms_per_frame']:.2f} ms/frame; launches {launches}",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return res


def encoders_phase(card: str, n_steps: int) -> dict:
    """The encoder variants on the card: the ``scratch50`` flagship step
    (default route, profiled), a small f32 ``scratch50`` step card vs CPU,
    the remat arms, the ResNet-50 eval at C = 1024, and #1 against its
    plain version on random and near-tie features at C = 1024 and 2048."""
    res = dict(train=train_arm(*DEFAULT_ARM, R50_LAUNCHES, n_steps,
                               profile=True, model_type="scratch50"))
    res["small_train"] = small_step_card_vs_cpu("scratch50", R50_LAUNCHES,
                                                f64_reference=True)
    res["remat"] = remat_arms(min(n_steps, 5))
    res["eval"] = resnet50_eval()
    res["prop1024"] = kernel_vs_plain(4, 1024)
    res["prop2048"] = kernel_vs_plain(3, 2048)
    t = res["train"]
    print(f"encoders on {card}: scratch50 step {t['step_ms']:.2f} ms, "
          f"{t['clips_per_s']:.2f} clips/s, MFU {100 * t['mfu']:.2f}% "
          f"({t['tflop_per_step']:.2f} TFLOP/step), {t['max_memory_gib']:.2f} "
          f"GiB; remat " + ", ".join(
              f"{k} {v['step_ms']:.2f} ms {v['max_memory_gib']:.2f} GiB"
              for k, v in res["remat"].items() if "step_ms" in v)
          + f"; ResNet-50 eval {res['eval']['e2e_ms_per_frame']:.2f} ms a "
          f"target frame; #1 at C=1024 {res['prop1024']['ms']:.3f} ms "
          f"(bound {res['prop1024']['bound_ms']:.3f}), at C=2048 "
          f"{res['prop2048']['ms']:.3f} ms (bound "
          f"{res['prop2048']['bound_ms']:.3f})", flush=True)
    return res


# multi-GPU (``videowalk_tpu_torch/parallel``) on one card: the NCCL path
# at world size 1 through the trainer, two gloo ranks sharing cuda:0 (NCCL
# takes one rank a device), #1 in tile-row bands, the multi-process dry run.
# (b)'s cases, in the form of ``parallel/dryrun.py``'s table: bench.py's
# flagship step (batch 8, 8 frames, 7x7 patches of 64 px) with a bf16 trunk
# and with an f32 one, and train.sh's superpixel step (batch 6, 4 frames of
# 256 px, SLIC 36 with randomised active counts, L1 dilation k=55) likewise,
# all under SGD: an update linear in the gradient, so that two ranks compare
# with one process (Adam's first step is the gradient's sign). The "fault"
# cases plant a fault in the gradient average (``PLANTED_FAULTS``) to show
# that the parameter check catches it.
_FLAGSHIP = dict(kind="patch", batch=8, T=8, N=49, px=64, optim="sgd",
                 model=dict(model_type="scratch"))
_SP_RECORD = dict(kind="sp", batch=6, T=4, px=256, n_segments=36,
                  randomise=10, optim="sgd", model=dict(
                      model_type="scratch", max_sp_num=49,
                      dilate_superpixels=True, dilation_kernel_size=55))
GLOO_CASES = dict(
    flagship=dict(_FLAGSHIP, model=dict(_FLAGSHIP["model"],
                                        dtype=torch.bfloat16)),
    flagship_f32=_FLAGSHIP,
    sp_record=dict(_SP_RECORD, model=dict(_SP_RECORD["model"],
                                          dtype=torch.bfloat16)),
    sp_record_f32=_SP_RECORD)
PARAM_HELD = ("flagship_f32", "sp_record_f32")
GLOO_FAULT_CASES = {f"{n}/{f}": dict(GLOO_CASES[n], fault=f)
                    for n in PARAM_HELD
                    for f in ("no_average", "half_average")}
# Two ranks against one process after MULTI_STEPS steps: the first loss
# within FIRST_LOSS_RTOL, every loss within LATER_LOSS_RTOL (~4x the largest
# later-loss gap read on the card, 2.58e-5 with the bf16 trunk); for the
# f32 cases the parameters within PARAM_UPDATE_TOL of the update (rel L2 of
# the gap over the update, all parameters as one vector; read on the card
# 2.9e-3 and 2.7e-3, the planted faults 0.497 to 1.39) and each tensor
# within PARAM_TENSOR_TOL (read 0.037 and 0.049). The bf16 cases' gaps
# (~0.15, each tensor ~0.27) are printed, not held: bf16 rounds each
# rank's activations apart from one process's, and the gradient at random
# weights and T 0.05 amplifies it.
MULTI_STEPS = 3
FIRST_LOSS_RTOL = 1e-4
LATER_LOSS_RTOL = 1e-4
PARAM_UPDATE_TOL = 0.03
PARAM_TENSOR_TOL = 0.25


def _no_average(params, group) -> None:
    """Planted fault: each rank keeps its own gradient."""


def _half_average(params, group) -> None:
    """Planted fault: half the mean gradient."""
    from videowalk_tpu_torch.parallel.mesh import average_gradients

    params = list(params)
    average_gradients(params, group)
    for p in params:
        if p.grad is not None:
            p.grad.mul_(0.5)


PLANTED_FAULTS = dict(no_average=_no_average, half_average=_half_average)


def measured_case(case: dict, device, group=None,
                  steps: int = MULTI_STEPS) -> dict:
    """``steps`` steps of a ``parallel/dryrun.py``-form ``case`` (with a
    process ``group``: this rank's rows), measured: the global losses,
    every training kernel's launches in these steps, the host clock's ms
    of each step (each ends in its loss read) and, on rank 0, the final
    parameters on the CPU. A ``fault`` of ``PLANTED_FAULTS`` stands in for
    the step's gradient average. The ``dryrun.run_ranks`` runner of the
    ``multi`` phase; TF32 is off here as in ``main``, since spawned ranks
    do not run ``main``."""
    from videowalk_tpu_torch.parallel import dryrun, multihost, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state, step = dryrun.case_steps(case, device, group)
    real = train_step.average_gradients
    if case.get("fault"):
        train_step.average_gradients = PLANTED_FAULTS[case["fault"]]
    try:
        before = sp_counts()
        losses, ms = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(step(i))
            ms.append((time.perf_counter() - t0) * 1e3)
        after = sp_counts()
    finally:
        train_step.average_gradients = real
    params = None
    if group is None or multihost.rank() == 0:
        params = {k: v.detach().float().cpu()
                  for k, v in state.model.named_parameters()}
    return dict(losses=losses, step_ms=ms, params=params,
                launches={k: after[k] - before[k] for k in after})


def world1_arm(name: str, distributed: bool, n_warmup: int, n_steps: int,
               workdir: str, videos: np.ndarray) -> dict:
    """The flagship patch loop through ``cli.train``'s ``build`` and
    ``train_one_epoch`` (``CLI_ARMS["flagship_patch"]``), plain or under
    ``--distributed`` with ``torchrun``'s variables for a world of one
    (``env://``, NCCL): every loss, ms a step by the host clock over the
    timed epoch, the launches of that epoch."""
    from videowalk_tpu_torch.cli import train as cli
    from videowalk_tpu_torch.parallel import multihost
    from videowalk_tpu_torch.utils.arguments import train_args

    out = os.path.join(workdir, name)
    argv = CLI_ARMS["flagship_patch"] + [
        "--output-dir", out, "--logs-dir", os.path.join(out, "logs"),
        "--steps-per-epoch", str(n_warmup)]
    args = train_args(argv + (["--distributed"] if distributed else []))
    if distributed:
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        multihost.initialize_from_args(args)
    try:
        import torch.distributed as dist

        backend = dist.get_backend() if dist.is_initialized() else None
        run = cli.build(args, multihost.local_device(args.device),
                        InMemoryClips(videos, args.clip_len))
        losses, real_step = [], run.step

        def step(state, batch, gen, sp_mask=None):
            m = real_step(state, batch, gen, sp_mask=sp_mask)
            losses.append(m["loss"])
            return m

        run.step, run.checkpoint_fn = step, None
        cli.train_one_epoch(args, run, 0)
        args.steps_per_epoch = n_steps
        torch.cuda.synchronize()
        set_sp_counts(dict.fromkeys(sp_counts(), 0))
        t0 = time.perf_counter()
        cli.train_one_epoch(args, run, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sp_counts()
        del run
    finally:
        if distributed:
            multihost.shutdown()
            for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                      "LOCAL_RANK"):
                os.environ.pop(k, None)
    torch.cuda.empty_cache()
    losses = [float(v) for v in losses]
    res = dict(arm=name, backend=backend, losses=losses,
               step_ms=wall / n_steps * 1e3, launches=launches)
    print(f"multi world-1 '{name}' (backend {backend}): "
          f"{res['step_ms']:.2f} ms/step over {n_steps} steps, first loss "
          f"{losses[0]!r}, launches {launches}", flush=True)
    return res


def nccl_world1(card: str, n_steps: int) -> dict:
    """(a) ``cli.train --distributed`` at world size 1 over NCCL against the
    plain loop, in turns (plain, NCCL, NCCL, plain): the first step's loss
    bitwise equal, the same launches, ms a step of each."""
    import shutil

    workdir = tempfile.mkdtemp(prefix="multi_w1_")
    videos = moving_textures(CLI_VIDEOS, CLI_FRAMES, RAW, seed=5)
    want = _want(dict(walk_fwd=1, walk_bwd=1, **dict(ARMS)[DEFAULT_ARM]))(
        n_steps, 0)
    try:
        arms = [world1_arm(f"{n}{i}", n == "nccl", 3, n_steps, workdir,
                           videos)
                for i, n in enumerate(("plain", "nccl", "nccl", "plain"))]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    plain = [a for a in arms if a["backend"] is None]
    nccl = [a for a in arms if a["backend"] is not None]
    if any(a["backend"] != "nccl" for a in nccl):
        fail(f"multi: --distributed formed {[a['backend'] for a in nccl]}, "
             f"not nccl")
    firsts = {a["losses"][0] for a in arms}
    if len(firsts) != 1:
        fail(f"multi: NCCL world 1's first loss differs from the plain "
             f"loop's: {[a['losses'][0] for a in arms]}")
    for a in arms:
        if a["launches"] != want or not np.all(np.isfinite(a["losses"])):
            fail(f"multi {a['arm']}: launches {a['launches']} (want {want}) "
                 f"or losses {a['losses']}")
    res = dict(card=card, first_loss=arms[0]["losses"][0],
               plain_ms=[a["step_ms"] for a in plain],
               nccl_ms=[a["step_ms"] for a in nccl], arms=arms)
    print(f"multi (a) NCCL world 1 vs plain loop on {card}: "
          f"{res['nccl_ms']} vs {res['plain_ms']} ms/step; first loss "
          f"bitwise equal ({res['first_loss']!r})", flush=True)
    return res


def _update_gap(got: dict, want: dict, init: dict) -> tuple:
    """``||got - want|| / ||want - init||`` over all parameters as one
    vector, and the largest over tensors with its name."""
    def flat(d, base=None):
        return torch.cat([(d[k] - (0 if base is None else base[k])).flatten()
                          for k in want])
    whole = float(flat(got, want).norm() / flat(want, init).norm())
    per = max((float((got[k] - want[k]).norm()
                     / (want[k] - init[k]).norm().clamp_min(1e-30)), k)
              for k in want)
    return whole, per


def gloo_two_ranks(card: str, ranks: list) -> dict:
    """(b) two gloo ranks on cuda:0 against one process on the global
    batch, ``MULTI_STEPS`` steps of each of ``GLOO_CASES``: the flagship
    patch step (global batch 8, 4 a rank) and train.sh's superpixel step
    (global batch 6, 3 a rank, SLIC #12 with active counts drawn for the
    global batch, dilation #11), each with a bf16 and an f32 trunk. Limits:
    ``FIRST_LOSS_RTOL``, ``LATER_LOSS_RTOL`` on the losses; the f32 cases'
    parameter gap within ``PARAM_UPDATE_TOL`` of the update (each tensor's
    within ``PARAM_TENSOR_TOL``), and each planted fault
    (``GLOO_FAULT_CASES``) beyond ``PARAM_UPDATE_TOL``; every training kernel
    launched in each rank as often as in one process. ``ranks``:
    ``dryrun.run_ranks``' results for these cases."""
    from videowalk_tpu_torch.parallel import dryrun

    res = {}
    for n, case in GLOO_CASES.items():
        one = measured_case(case, "cuda:0")
        init = {k: v.detach().float() for k, v in
                dryrun.case_model(case, 0).named_parameters()}
        torch.cuda.empty_cache()
        two = ranks[0][n]
        rel = [abs(a - b) / abs(b) for a, b in zip(two["losses"],
                                                   one["losses"])]
        gap, (per, per_name) = _update_gap(two["params"], one["params"], init)
        per_rank = [r[n]["launches"] for r in ranks]
        faults = {}
        for f in PLANTED_FAULTS if n in PARAM_HELD else ():
            bad = ranks[0][f"{n}/{f}"]
            fgap, (fper, _) = _update_gap(bad["params"], one["params"], init)
            faults[f] = dict(
                update_gap=fgap, update_gap_largest=fper,
                loss_rel=[abs(a - b) / abs(b) for a, b in
                          zip(bad["losses"], one["losses"])])
        res[n] = dict(losses_two=two["losses"], losses_one=one["losses"],
                      loss_rel=rel, update_gap=gap,
                      update_gap_largest=[per, per_name],
                      planted_faults=faults,
                      step_ms_two=[r[n]["step_ms"] for r in ranks],
                      step_ms_one=one["step_ms"],
                      launches_per_rank=per_rank,
                      launches_one=one["launches"])
        print(f"multi (b) gloo x2 on cuda:0 '{n}': losses {two['losses']} vs "
              f"one process {one['losses']} (rel {rel}), parameter gap "
              f"{gap:.3e} of the update (largest {per:.3e}, {per_name}); "
              + "".join(f"planted {f}: gap {v['update_gap']:.3e} (largest "
                        f"{v['update_gap_largest']:.3e}), loss rel "
                        f"{v['loss_rel']}; " for f, v in faults.items())
              + f"ms a step (host clock, steps 1-{MULTI_STEPS}) per rank "
              f"{res[n]['step_ms_two']}, one process {one['step_ms']}; "
              f"launches per rank {per_rank}, one process {one['launches']}",
              flush=True)
        if any(r[n]["losses"] != two["losses"] for r in ranks):
            fail(f"multi {n}: the ranks report other losses")
        if rel[0] > FIRST_LOSS_RTOL or max(rel) > LATER_LOSS_RTOL:
            fail(f"multi {n}: losses {two['losses']} vs {one['losses']}")
        if n in PARAM_HELD and (gap > PARAM_UPDATE_TOL
                                or per > PARAM_TENSOR_TOL):
            fail(f"multi {n}: parameter gap {gap} of the update ({per} in "
                 f"{per_name})")
        for f, v in faults.items():
            if v["update_gap"] <= PARAM_UPDATE_TOL:
                fail(f"multi {n}: the planted {f} fault's parameter gap "
                     f"{v['update_gap']} is within {PARAM_UPDATE_TOL}")
        for lr in per_rank:
            ran = {k for k, v in one["launches"].items() if v}
            if {k for k, v in lr.items() if v} != ran or any(
                    lr[k] != one["launches"][k] for k in ran):
                fail(f"multi {n}: a rank's launches {lr} differ from one "
                     f"process's {one['launches']}")
    return res


BAND_C, BAND_LABELS, BAND_TARGETS, BAND_DEVICES = 512, 16, 4, (2, 3, 8)


def banded_prop(card: str) -> dict:
    """(c) #1 in tile-row bands at DAVIS-480p (60x107, C 512, 16 labels, 1
    long + 20 short frames, k 10, r 12) over ``[cuda:0] * D`` for D in 2, 3
    and 8: ``propagate_labels`` over 4 targets bitwise equal to the
    unbanded run, one launch a band a target; each band's launch timed
    alone (CUDA events) beside the whole frame's."""
    from videowalk_tpu_torch.eval.propagation import propagate_labels

    feats, _ = prop_inputs("random", BAND_TARGETS, BAND_C)
    rows = context_index_bank(N_CONTEXT, LONG_MEM, BAND_TARGETS)
    lab = torch.rand((*feats.shape[:3], BAND_LABELS), device=feats.device,
                     generator=torch.Generator("cuda").manual_seed(4))
    lab = lab / lab.sum(-1, keepdim=True)
    f = feats.permute(0, 3, 1, 2)
    kw = dict(n_context=N_CONTEXT, n_long=len(LONG_MEM), topk=TOPK,
              temperature=TEMP, radius=RADIUS)
    want = propagate_labels(f, lab, rows, **kw)
    t = int(rows[0, -1]) + 2          # the second target reads a prediction
    ctx = torch.from_numpy(rows[1]).cuda()
    one = dict(n_long=len(LONG_MEM), topk=TOPK, temperature=TEMP,
               radius=RADIUS)
    res = dict(card=card, whole_ms=cuda_ms(
        lambda: ps.prop_sparse(feats, lab, ctx, t, **one), 10), bands={})
    for D in BAND_DEVICES:
        bands = ps.sparse_bands(H, D)
        before = ps.prop_sparse.launches
        got = propagate_labels(f, lab, rows, devices=["cuda:0"] * D, **kw)
        launches = ps.prop_sparse.launches - before
        if not torch.equal(got, want):
            fail(f"multi: #1 in {len(bands)} bands differs from unbanded "
                 f"(max {float((got - want).abs().max())})")
        if launches != BAND_TARGETS * len(bands):
            fail(f"multi: {launches} launches of #1 for {len(bands)} bands "
                 f"x {BAND_TARGETS} targets")
        ms = [cuda_ms(lambda b=b: ps.prop_sparse(feats, lab, ctx, t, rows=b,
                                                 **one), 10) for b in bands]
        res["bands"][D] = dict(bands=bands, launches=launches, band_ms=ms)
        print(f"multi (c) #1 over [cuda:0] x {D}: {len(bands)} bands "
              f"{bands}, bitwise equal to unbanded, {launches} launches for "
              f"{BAND_TARGETS} targets; ms a band {[f'{m:.3f}' for m in ms]} "
              f"(whole frame {res['whole_ms']:.3f}) on {card}", flush=True)
    return res


def multi_phase(card: str, n_steps: int) -> dict:
    """Multi-GPU on one card: (a) NCCL at world size 1 through the trainer,
    (b) two gloo ranks on cuda:0, (c) #1 in tile-row bands, (d) the dry
    run (``parallel/dryrun.py``) at world 2 over gloo on cuda:0, its cases
    in the same two ranks as (b)'s, then its eval checks."""
    from videowalk_tpu_torch.parallel import dryrun

    res = dict(nccl_world1=nccl_world1(card, n_steps))
    ranks = dryrun.run_ranks(
        {**GLOO_CASES, **GLOO_FAULT_CASES, **dryrun.DRYRUN_CASES}, 2,
        "cuda:0", "gloo", steps=MULTI_STEPS, runner=measured_case)
    res["gloo_two_ranks"] = gloo_two_ranks(card, ranks)
    res["bands"] = banded_prop(card)
    res["dryrun"] = dryrun.report(ranks, 2, "cuda:0")
    return res


# the users' launch recipes from files (files): train_torch.sh on a
# Kinetics-layout tree of videos written here with cv2 (the class folders
# of train_256, 25 fps, 340x256, decoded at --frame-skip 8: 32 frames, 5
# clips a video, 640 clips, 106 steps of 6 an epoch), then test_torch.sh
# on a DAVIS-2017 tree of 854x480 JPEG frames and palette annotations,
# with (b)'s checkpoint
FILES_CLASSES, FILES_PER_CLASS, FILES_FRAMES = 8, 16, 100
FILES_H, FILES_W, FILES_FPS = 256, 340, 25.0
FILES_CODEC, FILES_EXT = "mp4v", ".mp4"
FILES_EPOCHS = 2
DAVIS_H, DAVIS_W, DAVIS_FRAMES, DAVIS_CUT = 480, 854, 30, 8
DAVIS_OBJECTS = dict(video0=3, video1=2)
FILES_TIMEOUT_S = 600
# the trace of steps 5-9: kernel name -> the wrapper whose call launched it
# (a wrapper call launches one such kernel; walk.cu 4 each way, slic.cu 11
# a call, the slab kernels' reduce_rows beside them)
PX_WRAPPERS = dict(DX="dx", DX_BNIN="dx_bnin", FWD_STATS="fwd_stats",
                   FWD_BNIN_STATS="fwd_bnin_stats", FWD="fwd")
LAUNCH_OF = (("rconv_slab_dw<false>", "dw"), ("rconv_slab_dw<true>", "dw_bnin"),
             ("walk_cycle_fwd_kernel", "walk_fwd"),
             ("walk_dq_kernel", "walk_bwd"),
             ("slic_features_kernel", "slic_fused"),
             ("dilate_l1_kernel", "dilate_l1"),
             ("prop_sparse_kernel", "prop_sparse"))
DEVICE_LAUNCHES = dict(walk_=4, slic_=11)     # device kernels a call
# the lines of a recipe's output echoed here (with the host clock)
RUN_LINES = ("Epoch: [", "Epoch length", "Start training", "Total time",
             "dataset metadata", "Resumed from", "Training time", "Took",
             "Vid ", "computed features", "propagation (on-device)",
             "trace written", "wrote ", ": J=", "J&F-Mean", "WARNING")


# ``python`` as the recipes find it on the PATH: this interpreter. With
# FILES_CAPTURE set, ``python -m videowalk_tpu_torch.cli.test ...`` also
# saves each target's soft labels, as the dump receives them, to
# $FILES_CAPTURE/<prefix>.npy (the module runs as ``-m`` runs it); any
# other command line is this interpreter's own
PYTHON_LAUNCHER = """import os, runpy, sys
args, out = sys.argv[1:], os.environ.get("FILES_CAPTURE")
if not (out and args[:2] == ["-m", "videowalk_tpu_torch.cli.test"]):
    os.execv(sys.executable, [sys.executable] + args)
sys.path[0] = os.getcwd()            # as -m sets it
import numpy as np
from videowalk_tpu_torch.eval import test_utils
real = test_utils.dump_predictions
def dump(pred, lbl_map, img, prefix, **kw):
    np.save(os.path.join(out, os.path.basename(prefix) + ".npy"), pred)
    return real(pred, lbl_map, img, prefix, **kw)
test_utils.dump_predictions = dump
sys.argv = [args[1]] + args[2:]
runpy.run_module(args[1], run_name="__main__", alter_sys=True)
"""


def script_env(workdir: str, **extra) -> dict:
    """A user's shell environment for the launch recipes, with ``python``
    on the PATH this interpreter (through ``PYTHON_LAUNCHER``, so that a
    virtual environment's site stays its own)."""
    bindir = os.path.join(workdir, "bin")
    os.makedirs(bindir, exist_ok=True)
    launcher = os.path.join(bindir, "launcher.py")
    with open(launcher, "w") as fh:
        fh.write(PYTHON_LAUNCHER)
    wrapper = os.path.join(bindir, "python")
    with open(wrapper, "w") as fh:
        fh.write(f'#!/bin/sh\nexec "{sys.executable}" "{launcher}" "$@"\n')
    os.chmod(wrapper, 0o755)
    return dict(os.environ, PATH=os.pathsep.join(
        [bindir, os.environ.get("PATH", "/usr/bin:/bin")]),
        PYTHONUNBUFFERED="1", **extra)


def run_script(argv: list, env: dict, tag: str) -> dict:
    """``argv`` from the repository's root as its own process group, its
    output read line by line with the host clock's seconds since the
    start: ``{rc, lines: [(s, line)], seconds}``. A run past
    ``FILES_TIMEOUT_S`` has its whole group killed and fails; a run that
    exits non-zero fails with its last lines."""
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(
        __file__)), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, bufsize=1, start_new_session=True)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=FILES_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = None
    reader.join(10)
    seconds = time.perf_counter() - t0
    if rc != 0:
        tail = "\n".join(f"  | {line}" for _, line in lines[-60:])
        fail(f"files {tag}: {' '.join(argv)} exited with {rc} after "
             f"{seconds:.1f} s; its last lines:\n{tail}")
    print(f"files {tag}: {' '.join(argv)}: exit 0 in {seconds:.1f} s, "
          f"{len(lines)} lines; these of them:", flush=True)
    for s, line in lines:
        if any(k in line for k in RUN_LINES):
            print(f"  {s:7.1f} s | {line[:220]}", flush=True)
    return dict(rc=rc, lines=lines, seconds=seconds)


def cv2_video_io() -> str:
    """The Video I/O lines of cv2's build information."""
    import cv2

    out, on = [], False
    for line in cv2.getBuildInformation().splitlines():
        if line.strip().startswith("Video I/O"):
            on = True
        elif on and line.strip() and not line.startswith("    "):
            break
        if on:
            out.append(line)
    return "\n".join(out)


def write_kinetics_tree(root: str, seed: int) -> dict:
    """``root/class<c>/video<v>.mp4``: ``FILES_CLASSES`` x
    ``FILES_PER_CLASS`` videos of ``FILES_FRAMES`` frames of
    ``moving_texture`` (each from ``RandomState([seed, i])``), written by
    ``cv2.VideoWriter`` in eight threads, then the first video probed and
    decoded by the port's own reader (``data/clips.py``): its frame count
    and rate as written, its frames near the written ones (a lossy codec:
    mean |d| < 20 of 255). A writer or reader that fails raises with cv2's
    Video I/O build lines; nothing falls back to frames in memory."""
    import cv2
    from concurrent.futures import ThreadPoolExecutor

    from videowalk_tpu_torch.data.clips import _probe, decode_frames

    def one(i: int) -> str:
        c, v = divmod(i, FILES_PER_CLASS)
        path = os.path.join(root, f"class{c:02d}", f"video{v:02d}{FILES_EXT}")
        frames = moving_texture(np.random.RandomState([seed, i]),
                                FILES_FRAMES, FILES_H, FILES_W)
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*FILES_CODEC),
                              FILES_FPS, (FILES_W, FILES_H))
        if not out.isOpened():
            fail(f"files: cv2 cannot open a {FILES_CODEC} writer for {path}; "
                 f"cv2 {cv2.__version__}:\n{cv2_video_io()}")
        for f in frames:
            out.write(np.ascontiguousarray(f[:, :, ::-1]))
        out.release()
        return path

    for c in range(FILES_CLASSES):
        os.makedirs(os.path.join(root, f"class{c:02d}"), exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        paths = list(pool.map(one, range(FILES_CLASSES * FILES_PER_CLASS)))
    write_s = time.perf_counter() - t0
    try:
        n, fps = _probe(paths[0])
        got = decode_frames(paths[0], [0, FILES_FRAMES - 1]).astype(np.float32)
    except Exception as e:
        fail(f"files: the port's reader cannot read {paths[0]} ({e}); cv2 "
             f"{cv2.__version__}:\n{cv2_video_io()}")
    want = moving_texture(np.random.RandomState([seed, 0]), FILES_FRAMES,
                          FILES_H, FILES_W)[[0, -1]].astype(np.float32)
    err = float(np.abs(got - want).mean())
    nbytes = sum(os.path.getsize(p) for p in paths)
    res = dict(videos=len(paths), frames=FILES_FRAMES, fps=FILES_FPS,
               size=(FILES_W, FILES_H), codec=FILES_CODEC, write_s=write_s,
               mib=nbytes / 2 ** 20, probed=(n, fps), decode_mean_abs_err=err,
               cv2=cv2.__version__)
    print(f"files (a): {len(paths)} {FILES_CODEC} videos of {FILES_FRAMES} "
          f"frames at {FILES_W}x{FILES_H}, {FILES_FPS:g} fps, written by cv2 "
          f"{cv2.__version__} in {write_s:.1f} s ({res['mib']:.1f} MiB); "
          f"probed {n} frames at {fps:g} fps, decoded mean |d| {err:.2f} of "
          f"255", flush=True)
    if n != FILES_FRAMES or abs(fps - FILES_FPS) > 1e-3 or not err < 20:
        fail(f"files: {paths[0]} reads back as {n} frames at {fps} fps, mean "
             f"|d| {err:.2f}; cv2 {cv2.__version__}:\n{cv2_video_io()}")
    return res


def write_davis_tree(root: str, videos: dict) -> None:
    """A DAVIS-2017 tree: ``JPEGImages/480p/<v>/%05d.jpg`` (cv2, quality
    95), palette ``Annotations/480p/<v>/%05d.png`` (PIL, the DAVIS palette)
    and ``ImageSets/2017/val.txt``, from ``videos``: name -> (frames
    ``(T, h, w, 3)`` uint8 RGB, ids ``(T, h, w)``)."""
    import cv2
    from PIL import Image

    from videowalk_tpu_torch.eval.convert_davis import PALETTE

    for name, (frames, ids) in videos.items():
        jdir = os.path.join(root, "JPEGImages", "480p", name)
        adir = os.path.join(root, "Annotations", "480p", name)
        os.makedirs(jdir, exist_ok=True)
        os.makedirs(adir, exist_ok=True)
        for t, (f, lab) in enumerate(zip(frames, ids)):
            if not cv2.imwrite(os.path.join(jdir, f"{t:05d}.jpg"),
                               np.ascontiguousarray(f[:, :, ::-1]),
                               [cv2.IMWRITE_JPEG_QUALITY, 95]):
                fail(f"files: cv2 cannot write {jdir}/{t:05d}.jpg")
            im = Image.frombytes("P", lab.shape[::-1],
                                 np.ascontiguousarray(lab, np.uint8).tobytes())
            im.putpalette(PALETTE.ravel().tolist())
            im.save(os.path.join(adir, f"{t:05d}.png"))
    os.makedirs(os.path.join(root, "ImageSets", "2017"), exist_ok=True)
    with open(os.path.join(root, "ImageSets", "2017", "val.txt"), "w") as fh:
        fh.write("\n".join(videos) + "\n")


def parse_train_log(lines: list) -> list:
    """The trainer's ``MetricLogger`` lines: ``{s, epoch, step, total, loss,
    time, data}`` (``s`` the host clock's seconds since the run started;
    ``loss`` the window's median as printed; ``time`` and ``data`` the
    window's mean seconds a step, ``data`` the wait for the loader)."""
    import re

    pat = re.compile(r"Epoch: \[(\d+)\]\s+\[\s*(\d+)/(\d+)\].*loss: (\S+) "
                     r"\(.*time: (\S+)\s+data: (\S+)")
    out = []
    for s, line in lines:
        m = pat.search(line)
        if m:
            out.append(dict(s=s, epoch=int(m[1]), step=int(m[2]),
                            total=int(m[3]), loss=float(m[4]),
                            time=float(m[5]), data=float(m[6])))
    return out


def epoch_rates(log: list) -> dict:
    """Per epoch: ms a step by the host clock between the lines of steps 10
    and the last one (each line follows a fetch of that step's loss, so
    the span holds whole steps; step 0's start-up and the trace of steps
    5-9 lie before it), and the printed ``data`` and ``time`` means of the
    lines from step 20 on (their windows hold no step before 1)."""
    res = {}
    for e in sorted({r["epoch"] for r in log}):
        rows = [r for r in log if r["epoch"] == e]
        a = next(r for r in rows if r["step"] == 10)
        b = rows[-1]
        late = [r for r in rows if r["step"] >= 20]
        res[e] = dict(steps=b["total"],
                      ms_per_step=(b["s"] - a["s"]) / (b["step"] - a["step"])
                      * 1e3,
                      data_ms=float(np.mean([r["data"] for r in late])) * 1e3,
                      time_ms=float(np.mean([r["time"] for r in late])) * 1e3,
                      loss_first=rows[0]["loss"], loss_last=b["loss"])
    return res


def trace_launches(path: str) -> dict:
    """Wrapper calls in a ``--profile-dir`` trace, from the device kernels
    it names (``LAUNCH_OF``; ``rconv_slab_px<BN, m>`` by ``px_modes()``),
    with the device busy ms (the union of kernel intervals) and the
    window's ms (first to last event). Fails where a kernel family's
    device launches are not its calls' multiple or an f32 reflect-conv
    kernel ran."""
    import re

    kernels = trace_kernels(path)
    modes = px_modes()
    calls = dict.fromkeys(list(sp_counts()) + ["prop_sparse"], 0)
    for name, durs in sorted(kernels.items()):
        if any(p in name for p in ("rconv_", "walk_", "slic_", "dilate_",
                                   "prop_sparse", "reduce_rows")):
            print(f"    {len(durs):4d} x {np.mean(durs):9.2f} us  "
                  f"{name[:90]}", flush=True)
        m = re.search(r"rconv_slab_px<\d+, (\d+)>", name)
        if m:
            calls[PX_WRAPPERS[modes[int(m[1])]]] += len(durs)
            continue
        if "rconv_slab_px" in name or "rconv_gemm" in name:
            fail(f"files: trace kernel {name[:120]} is no bf16 slab mode")
        for part, wrapper in LAUNCH_OF:
            if part in name:
                calls[wrapper] += len(durs)
    for part, per in DEVICE_LAUNCHES.items():
        n = sum(len(v) for k, v in kernels.items()
                if re.search(r"(^|::)" + part, k))
        want = per * (calls["walk_fwd"] + calls["walk_bwd"]
                      if part == "walk_" else calls["slic_fused"])
        if n != want:
            fail(f"files: {n} {part}* device launches in the trace for "
                 f"{want // per} calls, want {per} a call")
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "kernel")
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (max(float(e["ts"]) + float(e["dur"]) for e in events)
              - min(float(e["ts"]) for e in events))
    return dict(calls=calls, busy_ms=busy / 1e3, window_ms=window / 1e3)


def host_clip_ms(kin: str, cache: str, n: int = 12) -> dict:
    """Median host ms of one training clip in this process, one thread:
    its cv2 decode (``VideoClipIndex.get_clip``) and the host
    augmentations at train.sh's flags (``TrainTransform``: crop, 256 px,
    the grid of 64 px patches), over the sampler's first ``n`` clips."""
    from videowalk_tpu_torch.cli.train import make_dataset
    from videowalk_tpu_torch.data.augs import get_train_transforms
    from videowalk_tpu_torch.data.clips import RandomClipSampler
    from videowalk_tpu_torch.utils.arguments import train_args

    args = train_args(["--data-path", kin, "--cache-path", cache,
                       "--cache-dataset", "--frame-aug", "grid",
                       "--clip-len", "4", "--prob", "0.7", "--output-dir",
                       "", "--logs-dir", ""])
    ds = make_dataset(args, get_train_transforms(args))
    ids = list(iter(RandomClipSampler(ds.video_clips, 5, seed=0)))[:n]
    rng = np.random.RandomState(0)
    times = {"decode": [], "augs": []}
    for i in ids:
        t0 = time.perf_counter()
        video = ds.video_clips.get_clip(i)[0]
        t1 = time.perf_counter()
        ds.transform(video, rng=rng)
        times["decode"].append((t1 - t0) * 1e3)
        times["augs"].append((time.perf_counter() - t1) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def files_train(workdir: str, env: dict, cli_ref: dict | None) -> dict:
    """(b) ``bash train_torch.sh --epochs 2 --output-dir ... --profile-dir
    ...`` on the Kinetics tree (host augmentations and cv2 decode in the
    loader's threads, SLIC #12 and dilation #11 on the card, the metadata
    cache written), its trace of steps 5-9 against the drawn paths, then
    ``--resume <checkpoint.pth> --epochs 3``, which must read the cache and
    continue at epoch 2."""
    ckdir = os.path.join(workdir, "ckpt")
    trace_dir = os.path.join(workdir, "trace")
    cache = env["CACHE_PATH"]
    run = run_script(["bash", "train_torch.sh", "--epochs", str(FILES_EPOCHS),
                      "--output-dir", ckdir, "--profile-dir", trace_dir], env,
                     "(b) train_torch.sh")
    text = "\n".join(line for _, line in run["lines"])
    log = parse_train_log(run["lines"])
    ck = os.path.join(ckdir, "checkpoint.pth")
    for what, bad in (("checkpoint.pth", not os.path.isfile(ck)),
                      ("the metadata cache", not os.path.isfile(cache)
                       or f"Saved dataset metadata to {cache}" not in text),
                      ("a decode (skipped idx)", "skipped idx" in text),
                      ("a probe", "failed to probe" in text),
                      ("both epochs", {r["epoch"] for r in log}
                       != set(range(FILES_EPOCHS))),
                      ("100 steps an epoch", any(r["total"] < 100
                                                 for r in log)),
                      ("a finite loss", not all(np.isfinite(r["loss"])
                                                for r in log))):
        if bad:
            fail(f"files (b): wrong {what}:\n" + text[-3000:])
    rates = epoch_rates(log)
    start = next(s for s, line in run["lines"] if "Start training" in line)
    # the trace of steps 5-9 of epoch 0 against the paths drawn there
    path = os.path.join(trace_dir, "train_epoch0_steps5-9.pt.trace.json")
    traced = trace_launches(path)
    paths = epoch_paths(0, 0, 10, 0.7)[5:]
    n_sp = paths.count(False)
    walk = dict(walk_fwd=1, walk_bwd=1)
    want = _want(dict(walk, **dict(ARMS)[DEFAULT_ARM]),
                 dict(walk, slic_fused=1, dilate_l1=1,
                      **SP_LAUNCHES["auto"]))(5 - n_sp, n_sp)
    got = {k: v for k, v in traced["calls"].items() if k in want}
    if got != want or not 0 < n_sp < 5:
        fail(f"files (b): the trace of steps 5-9 ({5 - n_sp} patch, {n_sp} "
             f"superpixel steps drawn) holds {got}, want {want}")
    res = dict(seconds=run["seconds"], start_training_s=start,
               first_step_s=log[0]["s"], epochs=rates,
               traced_paths=["patch" if p else "sp" for p in paths],
               trace=dict(launches=got,
                          device_ms_per_step=traced["busy_ms"] / 5,
                          window_ms_per_step=traced["window_ms"] / 5,
                          idle_share=1 - traced["busy_ms"]
                          / traced["window_ms"]),
               checkpoint=ck)
    for e, r in rates.items():
        print(f"files (b) epoch {e}: {r['steps']} steps, {r['ms_per_step']:.2f} "
              f"ms/step by the host clock (steps 10-{r['steps'] - 1}), data "
              f"{r['data_ms']:.2f} ms/step (the loader's wait), time "
              f"{r['time_ms']:.2f} ms/step (printed means from step 20); loss "
              f"{r['loss_first']:.4f} (first line) .. {r['loss_last']:.4f} "
              f"(last line)", flush=True)
    res["host_clip_ms"] = host_clip_ms(env["DATA_PATH"], cache)
    hc = res["host_clip_ms"]
    print(f"files (b) one clip on the host, one thread: cv2 decode "
          f"{hc['decode']:.2f} ms, host augmentations {hc['augs']:.2f} ms "
          f"(a batch of 6: {6 * (hc['decode'] + hc['augs']):.1f} ms of "
          f"loader work)", flush=True)
    tr = res["trace"]
    print(f"files (b) trace of steps 5-9 ({res['traced_paths']}): device busy "
          f"{tr['device_ms_per_step']:.2f} ms/step in a "
          f"{tr['window_ms_per_step']:.2f} ms window, idle share "
          f"{tr['idle_share']:.3f}; launches {got} = the drawn paths'; start "
          f"to 'Start training' {start:.1f} s, to the end of step 0 "
          f"{res['first_step_s']:.1f} s", flush=True)
    if cli_ref is not None:
        pr = cli_ref["profile"]
        print(f"files (b) beside train_cli (a) in memory, device augs, this "
              f"call: {cli_ref['step_ms']:.2f} ms/step, device busy "
              f"{pr['device_ms_per_step']:.2f} ms/step, idle share "
              f"{pr['idle_share']:.3f}", flush=True)
        res["train_cli_config_of_record"] = dict(
            step_ms=cli_ref["step_ms"], idle_share=pr["idle_share"],
            device_ms_per_step=pr["device_ms_per_step"])

    resumed = run_script(["bash", "train_torch.sh", "--epochs",
                          str(FILES_EPOCHS + 1), "--output-dir", ckdir,
                          "--resume", ck], env, "(b) --resume")
    text = "\n".join(line for _, line in resumed["lines"])
    rlog = parse_train_log(resumed["lines"])
    steps = sum(r["steps"] for r in rates.values())
    if (f"Loading dataset metadata from {cache}" not in text
            or "Saved dataset metadata" in text
            or f"step={steps}, start_epoch={FILES_EPOCHS}" not in text
            or {r["epoch"] for r in rlog} != {FILES_EPOCHS}
            or not all(np.isfinite(r["loss"]) for r in rlog)
            or "skipped idx" in text):
        fail("files (b): --resume did not read the cache and continue at "
             f"epoch {FILES_EPOCHS} from step {steps}:\n" + text[-3000:])
    res["resume"] = dict(seconds=resumed["seconds"],
                         first_step_s=rlog[0]["s"],
                         epoch=epoch_rates(rlog)[FILES_EPOCHS])
    print(f"files (b) --resume: read the cache, continued at epoch "
          f"{FILES_EPOCHS} from step {steps}: "
          f"{res['resume']['epoch']['ms_per_step']:.2f} ms/step, first step "
          f"ends {rlog[0]['s']:.1f} s after the start", flush=True)
    return res


def davis_jf(lines: list) -> float:
    """The J&F ``davis_metrics`` prints (``{'J&F-Mean': x, ...}``)."""
    import re

    for _, line in lines[::-1]:
        m = re.search(r"'J&F-Mean': ([-+0-9.eEnaif]+)", line)
        if m:
            return float(m[1])
    fail("files (c): davis_metrics printed no J&F")


def eval_times(lines: list, vid: int = 0) -> dict:
    """Video ``vid``'s encode and propagation seconds as ``cli.test``
    prints them."""
    out, on = {}, False
    for _, line in lines:
        if line.startswith("******* Vid "):
            on = line.startswith(f"******* Vid {vid} (")
        elif on and line.startswith("computed features"):
            out["encode_s"] = float(line.split()[-1])
        elif on and line.endswith("propagation (on-device)"):
            out["propagate_s"] = float(line.split()[0])
    return out


def files_chain(workdir: str, env: dict, davis: str, tag: str,
                extra: list) -> dict:
    """``bash test_torch.sh`` with ``extra`` through ``"$@"`` on the DAVIS
    tree ``davis``: exit 0, one converted PNG a frame, a finite J&F; the
    soft predictions the chain dumped (``PYTHON_LAUNCHER``), by prefix."""
    out = os.path.join(workdir, f"res_{tag}")
    capture = os.path.join(workdir, f"soft_{tag}")
    os.makedirs(capture)
    run = run_script(["bash", "test_torch.sh", *extra], dict(
        env, DAVIS=davis, OUT=out, FILES_CAPTURE=capture,
        VALLIST=os.path.join(workdir, f"list_{tag}.txt")), f"(c) {tag}")
    conv = out + "_converted"
    for name in os.listdir(os.path.join(davis, "JPEGImages", "480p")):
        n = len(os.listdir(os.path.join(davis, "JPEGImages", "480p", name)))
        got = sorted(os.listdir(os.path.join(conv, name)))
        if got != [f"{t:05d}.png" for t in range(n)]:
            fail(f"files (c) {tag}: {name} has {len(got)} converted PNGs for "
                 f"{n} frames")
    jf = davis_jf(run["lines"])
    if not np.isfinite(jf):
        fail(f"files (c) {tag}: J&F {jf}")
    soft = {f[:-4]: np.load(os.path.join(capture, f))
            for f in os.listdir(capture)}
    n_videos = len(os.listdir(os.path.join(davis, "JPEGImages", "480p")))
    return dict(seconds=run["seconds"], jf=jf, converted=conv,
                times=[eval_times(run["lines"], v) for v in range(n_videos)],
                soft=soft,
                objects=[line for _, line in run["lines"] if ": J=" in line])


def files_eval(workdir: str, env: dict, ckpt: str) -> dict:
    """(c) ``test_torch.sh`` on a DAVIS-2017 tree of 2 videos of
    ``DAVIS_FRAMES`` 854x480 frames (3 and 2 moving squares) at (b)'s
    checkpoint on the card (its second video traced: #1 once a target);
    then video0 cut to ``DAVIS_CUT`` frames through the chain on the card
    and with ``--device cpu``: J&F within 1e-3, and the soft predictions
    the two chains dumped within 1e-4 on >= 99.9% of label cells
    (``PERF.md`` section 2's eval limit)."""
    import shutil

    from PIL import Image

    davis = os.path.join(workdir, "davis")
    videos = {}
    for i, (name, n_obj) in enumerate(DAVIS_OBJECTS.items()):
        frames, ids, _ = moving_squares(DAVIS_FRAMES, DAVIS_H, DAVIS_W, n_obj,
                                        seed=20 + i)
        videos[name] = (frames, ids)
    write_davis_tree(davis, videos)
    cut = os.path.join(workdir, "davis_cut")
    for sub in ("JPEGImages", "Annotations"):
        dst = os.path.join(cut, sub, "480p", "video0")
        os.makedirs(dst)
        ext = ".jpg" if sub == "JPEGImages" else ".png"
        for t in range(DAVIS_CUT):
            shutil.copy(os.path.join(davis, sub, "480p", "video0",
                                     f"{t:05d}{ext}"), dst)
    os.makedirs(os.path.join(cut, "ImageSets", "2017"))
    with open(os.path.join(cut, "ImageSets", "2017", "val.txt"), "w") as fh:
        fh.write("video0\n")

    env = dict(env, CKPT=ckpt)
    trace_dir = os.path.join(workdir, "eval_trace")
    card = files_chain(workdir, env, davis, "card",
                       ["--profile-dir", trace_dir])
    traced = trace_launches(os.path.join(trace_dir,
                                         "test_video1.pt.trace.json"))
    n_soft = len(card.pop("soft"))
    if traced["calls"]["prop_sparse"] != DAVIS_FRAMES or n_soft != sum(
            len(v[0]) for v in videos.values()):
        fail(f"files (c): {traced['calls']['prop_sparse']} #1 launches in "
             f"the traced video, want {DAVIS_FRAMES}; {n_soft} predictions")
    n_frames = N_CONTEXT + DAVIS_FRAMES
    card["launches_video1"] = traced["calls"]["prop_sparse"]
    for vid, t in enumerate(card.pop("times")):
        card[f"video{vid}"] = dict(
            encode_ms_per_frame=t["encode_s"] * 1e3 / n_frames,
            prop_ms_per_target=t["propagate_s"] * 1e3 / DAVIS_FRAMES)
    print(f"files (c) card chain: J&F {card['jf']:.4f} ({card['objects']}), "
          f"{card['seconds']:.1f} s for the four commands; encode "
          f"{card['video0']['encode_ms_per_frame']:.2f} ms/frame (video 0, "
          f"the process's first), "
          f"{card['video1']['encode_ms_per_frame']:.2f} (video 1, traced), "
          f"propagation {card['video0']['prop_ms_per_target']:.2f} and "
          f"{card['video1']['prop_ms_per_target']:.2f} ms/target; #1 "
          f"{card['launches_video1']} launches in the traced video 1",
          flush=True)
    cut_card = files_chain(workdir, env, cut, "cut_card", [])
    cut_cpu = files_chain(workdir, env, cut, "cut_cpu", ["--device", "cpu"])
    diff = abs(cut_card["jf"] - cut_cpu["jf"])
    same = [np.mean(np.asarray(Image.open(os.path.join(
        cut_card["converted"], "video0", f))) == np.asarray(Image.open(
            os.path.join(cut_cpu["converted"], "video0", f))))
        for f in sorted(os.listdir(os.path.join(cut_cpu["converted"],
                                                "video0")))]
    got, want = cut_card.pop("soft"), cut_cpu.pop("soft")
    if sorted(got) != sorted(want) or len(got) != DAVIS_CUT:
        fail(f"files (c): {len(got)} card and {len(want)} CPU predictions "
             f"for {DAVIS_CUT} targets")
    err = np.concatenate([np.abs(got[k] - want[k]).max(-1).ravel()
                          for k in sorted(want)])
    res = dict(card=card, cut=dict(
        jf_card=cut_card["jf"], jf_cpu=cut_cpu["jf"], jf_diff=diff,
        cpu_chain_s=cut_cpu["seconds"], card_chain_s=cut_card["seconds"],
        mask_pixels_equal=float(np.mean(same)),
        pred_max_abs_err=float(err.max()),
        frac_over_1e4=float((err > 1e-4).mean())))
    print(f"files (c) video0 cut to {DAVIS_CUT} frames: J&F card "
          f"{cut_card['jf']:.4f}, CPU {cut_cpu['jf']:.4f} (|d| {diff:.1e}, "
          f"limit 1e-3); converted masks equal on "
          f"{res['cut']['mask_pixels_equal']:.6f} of pixels; soft "
          f"predictions card vs CPU max|d| {err.max():.3e}, cells |d|>1e-4 "
          f"{res['cut']['frac_over_1e4']:.5f} (limit: <= 1e-4 on >= 99.9%); "
          f"chain {cut_card['seconds']:.1f} s on the card, "
          f"{cut_cpu['seconds']:.1f} s on the CPU", flush=True)
    if diff > 1e-3 or res["cut"]["frac_over_1e4"] > 1e-3:
        fail("files (c): the card's and the CPU's eval of the cut video "
             "disagree")
    return res


def bn_drift(state: dict) -> dict:
    """How far a state's BN running statistics are from their init (mean 0,
    variance 1), over every channel of every layer."""
    means = torch.cat([v.flatten().double() for k, v in state.items()
                       if k.endswith("running_mean")])
    vars_ = torch.cat([v.flatten().double() for k, v in state.items()
                       if k.endswith("running_var")])
    return dict(channels=int(means.numel()),
                mean_abs_mean=float(means.abs().mean()),
                max_abs_mean=float(means.abs().max()),
                mean_abs_var_minus_1=float((vars_ - 1).abs().mean()),
                max_abs_var_minus_1=float((vars_ - 1).abs().max()))


def files_trained(ckpt: str, filelist: str) -> dict:
    """(d) the kernels at (b)'s trained weights: #1 against its plain
    version on the eval's own features of (c)'s video0 (cells over 1e-4,
    queries whose top-k id set differs), then the small f32 patch and
    superpixel steps card vs CPU with the checkpoint's weights and BN
    statistics (their limits as at the seeded init)."""
    from videowalk_tpu_torch.data.vos import VOSDataset
    from videowalk_tpu_torch.eval.test_utils import infer_downscale
    from videowalk_tpu_torch.utils.arguments import test_args
    from videowalk_tpu_torch.utils.checkpoint import load_checkpoint

    state = load_checkpoint(ckpt)["model"]
    drift = bn_drift(state)
    print(f"files (d) trained state: BN running statistics over "
          f"{drift['channels']} channels: |mean| {drift['mean_abs_mean']:.4f} "
          f"(max {drift['max_abs_mean']:.4f}), |var - 1| "
          f"{drift['mean_abs_var_minus_1']:.4f} (max "
          f"{drift['max_abs_var_minus_1']:.4f}); init 0 and 1", flush=True)
    args = test_args(["--filelist", filelist, "--cropSize", "-1",
                      "--videoLen", str(N_CONTEXT), "--device", "cuda"])
    args.mapScale = infer_downscale(8)
    imgs, _, lbls, _, _, _ = VOSDataset(args)[0]
    model = build_model(eval_args(), torch.device("cuda"))
    partial_load(state, model, skip_keys=["head"], verbose=False)
    before = ps.prop_sparse.launches
    prop = prop_against_plain(model, imgs, lbls, len(imgs) - N_CONTEXT,
                              "trained weights on the DAVIS files")
    feats = encode_video(model, imgs).permute(0, 2, 3, 1).contiguous()
    rows = context_index_bank(N_CONTEXT, LONG_MEM, len(imgs) - N_CONTEXT)
    prop["topk_differs"] = topk_set_differs(feats, rows, dict(
        n_long=len(LONG_MEM), topk=TOPK, temperature=TEMP, radius=RADIUS))
    ps.prop_sparse.launches = before
    print(f"files (d) #1 at trained weights: queries whose top-k ids differ "
          f"{prop['topk_differs']:.5f}", flush=True)
    del model, feats
    small = small_step_card_vs_cpu(state=state)
    small_sp = small_sp_step_card_vs_cpu(state=state)
    return dict(bn_drift=drift, prop=prop, small_step=small,
                small_sp_step=small_sp)


def files_phase(cli_ref: dict | None = None) -> dict:
    """The users' launch recipes from files, as a user runs them: (a) a
    Kinetics-layout tree of videos, (b) ``train_torch.sh`` on it and a
    ``--resume``, (c) ``test_torch.sh`` on a DAVIS tree at (b)'s
    checkpoint, card and CPU, (d) the kernels at the trained weights.
    ``cli_ref``: ``train_cli``'s arm (a) of this call (in memory, device
    augs), printed beside (b)."""
    import shutil

    workdir = tempfile.mkdtemp(prefix="files_")
    t0 = time.perf_counter()
    try:
        kin = os.path.join(workdir, "kinetics", "train_256")
        res = dict(tree=write_kinetics_tree(kin, seed=11))
        env = script_env(workdir, DATA_PATH=kin, CACHE_PATH=os.path.join(
            workdir, "cache", "kinetics.pt"))
        res["train"] = files_train(workdir, env, cli_ref)
        ckpt = res["train"]["checkpoint"]
        res["eval"] = files_eval(workdir, env, ckpt)
        res["trained"] = files_trained(
            ckpt, os.path.join(workdir, "list_card.txt"))
        # the checkpoint is the resumed run's: its last printed loss
        res["trained"]["walk_loss"] = dict(
            first=res["train"]["epochs"][0]["loss_first"],
            last=res["train"]["resume"]["epoch"]["loss_last"])
        print(f"files (d) walk loss at the first printed step "
              f"{res['trained']['walk_loss']['first']:.4f}, at the last "
              f"{res['trained']['walk_loss']['last']:.4f}", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"files: {res['seconds']:.1f} s", flush=True)
    return res


PHASES = dict(prop=lambda a: kernel_vs_plain(),
              eval=lambda a: end_to_end(a.targets),
              small_eval=lambda a: small_card_vs_cpu(),
              walk=lambda a: (walk_kernels_vs_plain(), walk_gate_sweep()),
              rconv=lambda a: rconv_kernels_vs_plain(),
              train=lambda a: train_step_phase(a.steps),
              small_train=lambda a: small_step_card_vs_cpu(),
              slic=lambda a: slic_kernel_vs_plain(),
              dilation=lambda a: dilation_kernel_vs_plain(),
              bn=lambda a: bn_kernels_vs_plain(),
              sp_train=lambda a: sp_train_phase(a.steps),
              small_sp_train=lambda a: small_sp_step_card_vs_cpu(),
              ts_train=lambda a: ts_train_phase(a.steps),
              small_ts_train=lambda a: small_ts_step_card_vs_cpu(),
              train_cli=lambda a: train_cli_phase(a.steps),
              eval_tail=lambda a: eval_tail_phase(a.card),
              encoders=lambda a: encoders_phase(a.card, a.steps),
              host_sp=lambda a: host_sp_phase(a.steps),
              multi=lambda a: multi_phase(a.card, a.steps),
              files=lambda a: files_phase())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--targets", type=int, default=40)
    # 5 timed steps: beside the files phase (two training epochs and a
    # resumed one from files, a CPU eval: ~290 s of a ~630 s run on an
    # "NVIDIA H100 80GB HBM3, 700.00 W") the whole run stays near 600 s
    ap.add_argument("--steps", type=int, default=5,
                    help="timed training steps (after 3 warm-up steps)")
    ap.add_argument("--out", default="", help="also write the results here")
    ap.add_argument("--phases", default="", help="comma-separated subset of "
                    f"{','.join(PHASES)} to run alone (for timing a kernel "
                    "while working on it): prints their lines and no result")
    args = ap.parse_args()
    only = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in only):
        ap.error(f"--phases takes {', '.join(PHASES)}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    args.card = smi
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {sorted(logs)} of {_build.sources()} in {build_s:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "C75")):
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    # the slab library's build log, kept beside it: also when an earlier
    # process built it
    slab_log = _build.build_log("rconv_slab")
    verdicts = wgmma_verdicts(slab_log or "")
    if slab_log is None:
        print("  ptxas wgmma verdicts absent: rconv_slab's library has no "
              "kept build log", flush=True)
    for kernel, verdict in verdicts.items():
        print(f"  ptxas wgmma verdict {kernel}: {verdict}", flush=True)
    for kernel, r in ptxas_resources(slab_log or "").items():
        print(f"  ptxas {kernel}: {r['registers']} registers, spill stores "
              f"{r['spill_stores']} B, spill loads {r['spill_loads']} B",
              flush=True)
    if verdicts:
        n_ser = sum(v.startswith("serialized") for v in verdicts.values())
        print(f"  ptxas serializes the wgmma of {n_ser} of {len(verdicts)} "
              f"slab kernels", flush=True)

    if only:
        for name in only:
            PHASES[name](args)
        print(f"partial run ({', '.join(only)}): no result line", flush=True)
        return 0
    phase_s = {}

    def timed(name, fn, *fn_args):
        t = time.perf_counter()
        out = fn(*fn_args)
        phase_s[name] = time.perf_counter() - t
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    kp = timed("prop", kernel_vs_plain)
    e2e = timed("eval", end_to_end, args.targets)
    small = timed("small_eval", small_card_vs_cpu)
    tail = timed("eval_tail", eval_tail_phase, smi)
    walk = timed("walk", walk_kernels_vs_plain)
    walk_sweep = timed("walk_sweep", walk_gate_sweep)
    rconv = timed("rconv", rconv_kernels_vs_plain)
    bn = timed("bn", bn_kernels_vs_plain)
    train = timed("train", train_step_phase, args.steps)
    small_train = timed("small_train", small_step_card_vs_cpu)
    slic_res = timed("slic", slic_kernel_vs_plain)
    dil = timed("dilation", dilation_kernel_vs_plain)
    sp_train = timed("sp_train", sp_train_phase, args.steps)
    small_sp_train = timed("small_sp_train", small_sp_step_card_vs_cpu)
    ts_train = timed("ts_train", ts_train_phase, args.steps)
    small_ts_train = timed("small_ts_train", small_ts_step_card_vs_cpu)
    train_cli = timed("train_cli", train_cli_phase, args.steps)
    encoders = timed("encoders", encoders_phase, smi, args.steps)

    kernels = [dict(
        name="prop_sparse_topk", route="cuda",
        source="videowalk_tpu_torch/ops/csrc/prop_sparse.cu",
        replaces="videowalk_tpu/ops/prop_sparse_kernel.py:67",
        launches=e2e["launches"], max_abs_err=kp["max_abs_err"], ms=kp["ms"],
        plain_ms=kp["plain_ms"], bound_ms=kp["bound_ms"],
        bound_by=kp["bound_by"], library_ms=None)]
    default = train["+".join(DEFAULT_ARM)]
    flag = walk["flagship"]
    for d, line, err in (("fwd", 70, flag["err"]["losses"]),
                         ("bwd", 118, flag["err"]["dq"])):
        kernels.append(dict(
            name=f"walk_{d}", route="cuda",
            source="videowalk_tpu_torch/ops/csrc/walk.cu",
            replaces=f"videowalk_tpu/ops/walk_kernel.py:{line}",
            launches=default["launches"][f"walk_{d}"], max_abs_err=err,
            ms=flag[f"{d}_ms"], plain_ms=flag[f"plain_{d}_ms"],
            bound_ms=flag["bounds"][d]["bound_ms"],
            bound_by=flag["bounds"][d]["bound_by"], library_ms=None))
    # #4 runs in the teacher-student step's teacher; the other six on the
    # default route
    runs = dict(train, teacher_student=ts_train["teacher_student"])
    rflag = rconv["flagship"]
    for name, line, arm in (("fwd", 224, "teacher_student"),
                            ("fwd_stats", 291, "auto+auto"),
                            ("fwd_bnin_stats", 401, "auto+auto"),
                            ("dx_bnin", 474, "auto+auto"),
                            ("dw_bnin", 553, "auto+auto"),
                            ("dx", 607, "auto+auto"), ("dw", 660, "auto+auto")):
        kernels.append(dict(
            name=f"reflect_conv_{name}", route="cuda",
            source="videowalk_tpu_torch/ops/csrc/rconv_slab.cu",
            replaces=f"videowalk_tpu/ops/rconv_kernel.py:{line}",
            launches=runs[arm]["launches"][name],
            max_abs_err=rflag["abs_err"][name], ms=rflag["ms"][name],
            plain_ms=rflag["plain_ms"].get(name, rflag["plain_ms"]["bwd"]),
            bound_ms=rflag["bounds"][name]["bound_ms"],
            bound_by=rflag["bounds"][name]["bound_by"],
            library_ms=rflag["library_ms"][name]))
    headline = sp_train["sp_dil"]
    kernels.append(dict(
        name="dilate_l1", route="cuda",
        source="videowalk_tpu_torch/ops/csrc/dilation.cu",
        replaces="videowalk_tpu/ops/dilation_kernel.py:71",
        launches=headline["launches"]["dilate_l1"], max_abs_err=dil["max_abs_err"],
        ms=dil["ms"], plain_ms=dil["plain_ms"], bound_ms=dil["bound_ms"],
        bound_by=dil["bound_by"], library_ms=dil["library_ms"]))
    kernels.append(dict(
        name="slic_fused", route="cuda",
        source="videowalk_tpu_torch/ops/csrc/slic.cu",
        replaces="videowalk_tpu/ops/slic_kernel.py:80",
        launches=headline["launches"]["slic_fused"],
        max_abs_err=slic_res["max_abs_err"], ms=slic_res["ms"],
        plain_ms=slic_res["plain_ms"], bound_ms=slic_res["bound_ms"],
        bound_by=slic_res["bound_by"], library_ms=None))
    host_sp = timed("host_sp", host_sp_phase, args.steps,
                    {k["name"]: k["ms"] for k in kernels})
    multi = timed("multi", multi_phase, smi, args.steps)
    kernels[0]["band_launches"] = {
        str(d): b["launches"] for d, b in multi["bands"]["bands"].items()}
    files = timed("files", files_phase, train_cli["config_of_record"])
    # launches in the traced windows of the file runs: training steps 5-9
    # of train_torch.sh (b), video 1 of test_torch.sh (c)
    traced = dict(files["train"]["trace"]["launches"],
                  prop_sparse=files["eval"]["card"]["launches_video1"])
    for k in kernels:
        name = {"prop_sparse_topk": "prop_sparse"}.get(
            k["name"], k["name"].removeprefix("reflect_conv_"))
        if traced.get(name):
            k["files_launches"] = traced[name]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(card=smi, build_s=build_s, kernel=kp,
                           end_to_end=e2e, small=small, eval_tail=tail,
                           walk=walk,
                           walk_sweep=walk_sweep,
                           rconv=rconv, bn=bn, train=train,
                           small_train=small_train,
                           slic=slic_res, dilation=dil, sp_train=sp_train,
                           small_sp_train=small_sp_train,
                           ts_train=ts_train, small_ts_train=small_ts_train,
                           train_cli=train_cli, encoders=encoders,
                           host_sp=host_sp, multi=multi, files=files,
                           kernels=kernels, phase_s=phase_s,
                           ptxas=logs,
                           wgmma_verdicts=verdicts), fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
