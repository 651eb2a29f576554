#!/usr/bin/env python3
"""Smoke test of the PyTorch port's eval and training paths on one NVIDIA
card.

    python3 chip_smoke.py [--targets 40] [--steps 10] [--out results/chip_smoke.json]
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
   ``wgmma`` (C7513, C7515)? (The parent tree's kernels are timed by
   running its own ``--phases rconv`` from an unpacked copy in the same
   call.)
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

Prints one JSON line of kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``. Any failed phase raises (non-zero exit,
no result). It needs a CUDA card and the repository around it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

from videowalk_tpu_torch.cli.test import build_model, encode_video, test
from videowalk_tpu_torch.eval.propagation import context_index_bank
from videowalk_tpu_torch.core.masks import make_dilation_kernel
from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.models.crw import superpixel_pool_weights
from videowalk_tpu_torch.ops import _build
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

# DAVIS-480p eval geometry of the config of record
H, W, C, NL = 60, 107, 256, 4
N_CONTEXT, LONG_MEM, TOPK, RADIUS, TEMP = 20, [0], 10, 12.0, 0.05
FP32_PEAK = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
BF16_PEAK = 989e12       # H100 SXM dense bf16 FLOP/s (tensor cores)
TF32_PEAK = 495e12       # H100 SXM dense TF32 FLOP/s (tensor cores)
HBM_RATE = 3.35e12       # H100 SXM bytes/s
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


def prop_inputs(kind: str, n_targets: int):
    """Features ``(N, H, W, C)`` (unit rows) and the label buffer ``(N, H,
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
        f = rng.randn(N, H, W, C).astype(np.float32)
        lab[:N_CONTEXT + 1] = np.eye(NL, dtype=np.float32)[
            rng.randint(0, NL, (H, W))]
    else:
        tex = lowfreq_features(rng, H, W, C)
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


def kernel_vs_plain(n_targets: int = 4) -> dict:
    """Phase 2: kernel and plain version target by target on one shared
    label buffer (each target's kernel prediction written back, as the
    eval writes it), on the random and the near-tie feature sets; the share
    of queries whose top-k ids differ; times on the random set."""
    rows = context_index_bank(N_CONTEXT, LONG_MEM, n_targets)
    kw = dict(n_long=len(LONG_MEM), topk=TOPK, temperature=TEMP,
              radius=RADIUS)
    for c, k, r in ((C, TOPK, RADIUS), (512, 32, RADIUS), (576, 10, RADIUS),
                    (20, 32, 12.5), (256, 10, 40.0)):
        src = int(ps._lib().prop_sparse_smem_bytes(c, k, ps.sparse_halo(r)))
        if src != ps.smem_bytes(c, k, r):
            fail(f"prop_sparse.smem_bytes({c}, {k}, {r}) = "
                 f"{ps.smem_bytes(c, k, r)}, the source's {src}")
    res = {}
    for kind in ("random", "near_tie"):
        feats, buf = prop_inputs(kind, n_targets)
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
        print(f"prop_sparse vs plain at DAVIS-480p, {kind} features "
              f"({n_targets} targets, autoregressive): max|d| "
              f"{r['max_abs_err']:.3e} mean|d| {r['mean_abs_err']:.3e} cells "
              f"|d|>1e-4 {r['frac_over_1e4']:.5f} (tolerance: |d| <= 1e-4 on "
              f">= 99.9% of cells); queries whose top-k ids differ "
              f"{r['topk_differs']:.5f}", flush=True)
        if r["frac_over_1e4"] > 1e-3:
            fail(f"kernel disagrees with its plain version on more than 0.1% "
                 f"of cells by more than 1e-4 ({kind} features)")
        if kind == "random":
            idx = torch.from_numpy(rows[-1]).cuda()
            t_last = int(rows[-1, -1]) + 1
            r["ms"] = cuda_ms(
                lambda: ps.prop_sparse(feats, buf, idx, t_last, **kw), 20)
            r["plain_ms"] = cuda_ms(lambda: ps.prop_sparse_plain(
                feats, buf, idx, t_last, **kw), 3, 1)
            print(f"prop_sparse {r['ms']:.3f} ms/target (median of 20), "
                  f"plain {r['plain_ms']:.3f} ms/target", flush=True)
        res[kind] = r
        del feats, buf
    L = rows.shape[1]
    pairs = ps.valid_pairs(H, W, RADIUS, len(LONG_MEM), L - len(LONG_MEM))
    scored = scored_pairs(L)
    flops = 2.0 * C * pairs
    nbytes = 4.0 * ((L + 1) * H * W * C + L * H * W * NL + H * W * NL) + 4 * L
    res.update(res.pop("random"))
    res.update(pairs=pairs, scored_pairs=scored, gflop=flops / 1e9,
               ops_ms=flops / FP32_PEAK * 1e3,
               tf32_ms=3 * flops / TF32_PEAK * 1e3,
               bytes_ms=nbytes / HBM_RATE * 1e3)
    res["bound_ms"] = max(res["ops_ms"], res["bytes_ms"])
    res["bound_by"] = "operations" if res["ops_ms"] >= res["bytes_ms"] \
        else "bytes"
    print(f"prop_sparse bound {res['bound_ms']:.3f} ms "
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


def synthetic_video(n_frames: int, h: int, w: int, seed: int):
    """Moving squares on a noisy background: uint8 frames (with the
    videoLen prefix of frame-0 copies) and one-hot labels (background + 2
    objects) at feature resolution (8x8 area average)."""
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

    def keep(pred, lbl_map, img, prefix):
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


def wgmma_verdicts(log: str) -> dict:
    """ptxas's verdict on each slab kernel of a build log: whether it
    serializes the kernel's ``wgmma`` (C7513, C7515: the reason as ptxas
    gives it), by instantiation: ``rconv_slab_px<BN, MODE>``,
    ``rconv_slab_dw<BNIN>``."""
    import re

    modes = px_modes()

    def readable(mangled):
        m = re.search(r"(rconv_slab_(?:px|dw))I((?:L[ib]\d+E)+)E", mangled)
        if not m:
            return None
        args = re.findall(r"L[ib](\d+)E", m.group(2))
        if m.group(1) == "rconv_slab_px":
            return f"rconv_slab_px<{args[0]}, {modes[int(args[1])]}>"
        return f"rconv_slab_dw<{'true' if args[0] == '1' else 'false'}>"

    out = {}
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        name = m and readable(m.group(1))
        if name:
            out.setdefault(name, "not serialized")
        c = re.search(r"\((C751\d)\)(.*?)(?:in the function '([^']+)')", line)
        if c and readable(c.group(3)):
            out[readable(c.group(3))] = (f"serialized ({c.group(1)}:"
                                         f"{c.group(2).rstrip()})")
    return out


def rconv_counts() -> dict:
    return {name: f.launches for name, f in RCONV}


def set_rconv_counts(counts: dict) -> None:
    for name, f in RCONV:
        f.launches = counts[name]


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


def seeded_crw(cfg: CRWConfig, seed: int) -> CRW:
    """The model, initialized on the CPU from ``seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return CRW(cfg)


def profile_steps(run, n: int = 3) -> dict:
    """``n`` more steps (``run()`` takes one) under ``torch.profiler``:
    device time by kernel and by kind, and the device's idle share of the
    host clock's window (one stream, so kernel times add up)."""
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
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            kernels[e.key] = kernels.get(e.key, 0.0) + t
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
              n_warmup: int = 3, profile: bool = False) -> dict:
    """``bench.py``'s flagship training step with the reflect convs routed
    by ``rconv`` / ``bn_fuse``: seeded init, ``n_warmup`` steps, then
    ``n_steps`` timed ones with every kernel count zeroed just before and
    read just after. Each walk kernel must run once a step and each
    reflect-conv kernel ``expect[name]`` times a step."""
    dev = torch.device("cuda")
    cfg = CRWConfig(model_type="scratch", temperature=WALK_TEMP,
                    edgedrop_rate=EDGEDROP, dtype=torch.bfloat16,
                    rconv=rconv, bn_fuse=bn_fuse)
    state = create_train_state(seeded_crw(cfg, seed=0),
                               make_optimizer(lr=3e-4), device=dev)
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
    t0 = time.perf_counter()
    metrics = [step(state, batch, gen) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_steps
    launches = dict(walk_fwd=wk.walk_fwd.launches,
                    walk_bwd=wk.walk_bwd.launches, **rconv_counts())
    losses = [float(m["loss"]) for m in metrics]
    want = dict(walk_fwd=n_steps, walk_bwd=n_steps,
                **{k: v * n_steps for k, v in expect.items()})
    tag = f"rconv={rconv!r}, bn_fuse={bn_fuse!r}"
    if launches != want:
        fail(f"{tag}: kernel launches {launches} in {n_steps} steps, want "
             f"{want}")
    if not all(np.isfinite(losses)):
        fail(f"{tag}: non-finite training loss: {losses}")
    flops = 3 * conv_fwd_flops_per_image() * BATCH * CLIP_LEN * N_PATCHES
    res = dict(rconv=rconv, bn_fuse=bn_fuse, steps=n_steps, step_ms=dt * 1e3,
               clips_per_s=BATCH / dt, tflop_per_step=flops / 1e12,
               mfu=flops / dt / BF16_PEAK,
               max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               losses=losses, launches=launches,
               launches_per_step={k: v / n_steps for k, v in launches.items()},
               state_step=state.step,
               acc_last={k: float(v) for k, v in metrics[-1].items()
                         if k.startswith("acc")})
    print(f"training step {tag}, bench.py config (batch {BATCH}, {CLIP_LEN} "
          f"frames, {N_PATCHES}x{PATCH}px patches, bf16 trunk): "
          f"{res['step_ms']:.2f} ms/step over {n_steps} steps, "
          f"{res['clips_per_s']:.2f} clips/s, {res['tflop_per_step']:.2f} "
          f"TFLOP/step (analytic convs), MFU {100 * res['mfu']:.2f}% of "
          f"{BF16_PEAK / 1e12:.0f} TFLOP/s bf16; peak memory "
          f"{res['max_memory_gib']:.2f} GiB; losses {losses[0]:.4f} .. "
          f"{losses[-1]:.4f}; launches per step {res['launches_per_step']}",
          flush=True)
    if profile:   # 3 more steps, after the path's counts were read
        res["profile"] = profile_steps(lambda: step(state, batch, gen))
    del state, batch
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


def small_step_card_vs_cpu() -> dict:
    """Phase 7: one f32 forward/backward with every supported reflect conv
    routed and every block on the BN-input chain (the default routes),
    card (kernels) vs CPU
    (plain versions), same weights, same 64 px clips, same edge-drop masks.
    Tolerances: loss rtol 1e-4 and q atol 1e-4 (f32 convolutions by
    different algorithms); gradients 2e-2 relative in L2 over all
    parameters (the early layers' f32 gradients are badly conditioned at
    random weights; the CPU tests measure the same spread against JAX and
    f64)."""
    B, T, N = 2, 4, 4
    cfg = CRWConfig(model_type="scratch", temperature=WALK_TEMP)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(B, T, N, PATCH, PATCH, 3).astype(np.float32))
    masks = [torch.from_numpy(rng.rand(B, T - 1, N, N) < EDGEDROP)
             for _ in range(2)]
    out = {}
    before = (wk.walk_fwd.launches, wk.walk_bwd.launches, rconv_counts())
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        model = seeded_crw(cfg, seed=3).to(dev)
        q, loss, _ = model(x.to(dev), train=True,
                           walk_masks=[m.to(dev) for m in masks])
        loss.backward()
        out[name] = (q.detach().cpu(), float(loss.detach()),
                     {k: p.grad.cpu() for k, p in model.named_parameters()})
    launched = dict(walk_fwd=wk.walk_fwd.launches - before[0],
                    walk_bwd=wk.walk_bwd.launches - before[1],
                    **{k: v - before[2][k] for k, v in rconv_counts().items()})
    wk.walk_fwd.launches, wk.walk_bwd.launches = before[:2]  # not the path's
    set_rconv_counts(before[2])
    (qc, lc, gc), (qh, lh, gh) = out["cuda"], out["cpu"]
    num = sum(float(((gc[k] - gh[k]) ** 2).sum()) for k in gh)
    den = sum(float((gh[k] ** 2).sum()) for k in gh)
    res = dict(loss_cuda=lc, loss_cpu=lh, loss_rel=abs(lc - lh) / abs(lh),
               q_max_abs_err=float((qc - qh).abs().max()),
               grad_rel_l2=(num / den) ** 0.5, kernel_launches=launched)
    print(f"small f32 step (B,T,N)=({B},{T},{N}) {PATCH}px, default "
          f"routes, card "
          f"vs CPU: loss {lc:.6f} vs {lh:.6f} (rel {res['loss_rel']:.2e}), q "
          f"max|d| {res['q_max_abs_err']:.2e}, grads rel L2 "
          f"{res['grad_rel_l2']:.2e} (tolerance: loss rtol 1e-4, q 1e-4, "
          f"grads 2e-2); kernel launches on the card {launched}", flush=True)
    if launched != dict(walk_fwd=1, walk_bwd=1, **dict(ARMS)[DEFAULT_ARM]):
        fail("the card's small step did not go through the walk and the "
             "reflect-conv kernels")
    if not (res["loss_rel"] <= 1e-4 and res["q_max_abs_err"] <= 1e-4
            and res["grad_rel_l2"] <= 2e-2):
        fail("card and CPU training steps disagree")
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
        if e.device_type != torch.autograd.DeviceType.CUDA:
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
                 n_steps: int, n_warmup: int = 3, profile: bool = False) -> dict:
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
                    max_sp_num=MAX_SP, dilate_superpixels=dilate,
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
    t0 = time.perf_counter()
    metrics = [run() for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_steps
    launches = sp_counts()
    losses = [float(m["loss"]) for m in metrics]
    want = {k: v * n_steps for k, v in expect.items()}
    if launches != want:
        fail(f"{name}: kernel launches {launches} in {n_steps} steps, want "
             f"{want}")
    if not all(np.isfinite(losses)):
        fail(f"{name}: non-finite training loss: {losses}")
    res = dict(arm=name, steps=n_steps, step_ms=dt * 1e3,
               clips_per_s=SP_BATCH / dt,
               max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               losses=losses, launches=launches,
               launches_per_step={k: v / n_steps for k, v in launches.items()},
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
          f"{losses[0]:.4f} .. {losses[-1]:.4f}; launches per step {per_step}",
          flush=True)
    if profile:   # after the path's counts were read
        res["profile"] = profile_steps(run)
        mask = slic_fused(unnorm, NUM_SP, COMPACTNESS)
        pool = dict(dilate=dilate, dilation_kernel_size=DIL_K)
        res["stages_ms"] = dict(
            slic=cuda_ms(lambda: slic_fused(unnorm, NUM_SP, COMPACTNESS), 10),
            pool_weights=cuda_ms(lambda: superpixel_pool_weights(
                mask, MAX_SP, (32, 32), **pool), 10),
            pool_weights_undilated=cuda_ms(lambda: superpixel_pool_weights(
                mask, MAX_SP, (32, 32)), 10))
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


def small_sp_step_card_vs_cpu() -> dict:
    """One small f32 superpixel forward/backward (64x64 frames, 12 node
    slots, L1 dilation k=7, the default routes) on the card (kernels)
    against the CPU (plain versions): same weights, frames, edge-drop masks
    and the **same** labels (the card's ``slic_fused``, 9 segments, so
    every frame has absent slots). Tolerances as the small patch step's:
    loss rtol 1e-4, q atol 1e-4, gradients 2e-2 relative in L2."""
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
        model = seeded_crw(cfg, seed=3).to(dev)
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
    print(f"small f32 superpixel step (B,T)=({B},{T}) {h}px, {sp_slots} slots "
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


PHASES = dict(prop=lambda a: kernel_vs_plain(),
              eval=lambda a: end_to_end(a.targets),
              small_eval=lambda a: small_card_vs_cpu(),
              walk=lambda a: (walk_kernels_vs_plain(), walk_gate_sweep()),
              rconv=lambda a: rconv_kernels_vs_plain(),
              train=lambda a: train_step_phase(a.steps),
              small_train=lambda a: small_step_card_vs_cpu(),
              slic=lambda a: slic_kernel_vs_plain(),
              dilation=lambda a: dilation_kernel_vs_plain(),
              sp_train=lambda a: sp_train_phase(a.steps),
              small_sp_train=lambda a: small_sp_step_card_vs_cpu())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--targets", type=int, default=40)
    ap.add_argument("--steps", type=int, default=10,
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
    if verdicts:
        n_ser = sum(v.startswith("serialized") for v in verdicts.values())
        print(f"  ptxas serializes the wgmma of {n_ser} of {len(verdicts)} "
              f"slab kernels", flush=True)

    if only:
        for name in only:
            PHASES[name](args)
        print(f"partial run ({', '.join(only)}): no result line", flush=True)
        return 0
    kp = kernel_vs_plain()
    e2e = end_to_end(args.targets)
    small = small_card_vs_cpu()
    walk = walk_kernels_vs_plain()
    walk_sweep = walk_gate_sweep()
    rconv = rconv_kernels_vs_plain()
    train = train_step_phase(args.steps)
    small_train = small_step_card_vs_cpu()
    slic_res = slic_kernel_vs_plain()
    dil = dilation_kernel_vs_plain()
    sp_train = sp_train_phase(args.steps)
    small_sp_train = small_sp_step_card_vs_cpu()

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
    # #4 runs on the route-on, BN-unfused path; the other six on the default
    rflag = rconv["flagship"]
    for name, line, arm in (("fwd", 224, "on+off"), ("fwd_stats", 291, "auto+auto"),
                            ("fwd_bnin_stats", 401, "auto+auto"),
                            ("dx_bnin", 474, "auto+auto"),
                            ("dw_bnin", 553, "auto+auto"),
                            ("dx", 607, "auto+auto"), ("dw", 660, "auto+auto")):
        kernels.append(dict(
            name=f"reflect_conv_{name}", route="cuda",
            source="videowalk_tpu_torch/ops/csrc/rconv_slab.cu",
            replaces=f"videowalk_tpu/ops/rconv_kernel.py:{line}",
            launches=train[arm]["launches"][name],
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
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(card=smi, build_s=build_s, kernel=kp,
                           end_to_end=e2e, small=small, walk=walk,
                           walk_sweep=walk_sweep,
                           rconv=rconv, train=train, small_train=small_train,
                           slic=slic_res, dilation=dil, sp_train=sp_train,
                           small_sp_train=small_sp_train,
                           kernels=kernels, ptxas=logs,
                           wgmma_verdicts=verdicts), fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
