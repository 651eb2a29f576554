#!/usr/bin/env python3
"""Smoke test of the PyTorch port's eval and training paths on one NVIDIA
card.

    python3 chip_smoke.py [--targets 40] [--steps 10] [--out results/chip_smoke.json]

1. Prints the card's name and power limit, builds every CUDA kernel of
   ``videowalk_tpu_torch/ops/csrc`` (one nvcc each, started together).
2. Holds the block-sparse top-k propagation kernel against its plain
   PyTorch version at DAVIS-480p geometry (C=256, 60x107 maps, 1 long + 20
   short context frames, k=10, r=12, T=0.05, 4 labels), target by target on
   one shared label buffer, and times both with CUDA events.
3. Drives the eval slice end to end through ``cli.test.test()``: a seeded
   random-init ``scratch`` CRW (ResNet-18, layer4 removed, C=256) on a
   synthetic 480x854 video with moving squares and 3 labels, 20-frame
   prefix + ``--targets`` frames. Kernel launch counts are zeroed just
   before that run and read just after it.
4. Checks the result: finite predictions of the right shape, the first
   target equal to the frame-0 ground truth, one launch per target, and the
   card's end-to-end predictions against the CPU path on a small video.

5. Holds the fused walk kernels (forward and backward, ``ops/csrc/walk.cu``)
   against their plain PyTorch version with rate-0.1 edge-drop masks at the
   flagship shape (B=8, T=8, N=49, C=128) and at the gate's edge (T=10,
   N=128, C=512), and times both with CUDA events.
6. Holds the reflect-conv kernels (``ops/csrc/rconv.cu``: forward #4,
   forward with BN moments #5, dx #9, dW #10) against their plain PyTorch
   version on bf16 inputs at the step's shapes (the layer4 interior, 3136
   images of 8x8 with 512 channels; layer1's 16x16x64; 8x8 128->256; a
   32x32x512 map), and times kernel, plain version and the library call
   (``F.pad`` + cuDNN ``conv2d`` and its autograd backward) with CUDA
   events.
7. Drives the training slice: ``bench.py``'s flagship step (8-frame clips,
   batch 8, a 7x7 grid of 64 px patches, the ``scratch`` ResNet-18 with a
   bf16 trunk in BN-train mode, edge dropout 0.1, T 0.05, Adam lr 3e-4)
   from a seeded init through ``make_train_step``, in four arms one after
   another that differ only by the reflect-conv route: ``rconv='off'``
   (cuDNN), the default ``auto`` + ``bn_fuse='stats'``, ``on`` + ``stats``
   and ``on`` + ``off``. Each arm takes 3 warm-up steps, then ``--steps``
   timed ones with every kernel count zeroed just before and read just
   after: every loss must be finite, each walk kernel launched once a step
   and each reflect-conv kernel as often as the route says. The default
   arm takes 3 more steps under ``torch.profiler``: device time by kernel
   and kind, idle share.
8. A small f32 step with ``rconv='on'`` (64 px patches) on the card
   against the same step on the CPU (plain versions), same weights and
   edge-drop masks: loss and gradients.

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
from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.ops import _build
from videowalk_tpu_torch.ops import prop_sparse as ps
from videowalk_tpu_torch.ops import rconv as rc
from videowalk_tpu_torch.ops import walk as wk
from videowalk_tpu_torch.parallel import (create_train_state, make_optimizer,
                                          make_train_step)

# DAVIS-480p eval geometry of the config of record
H, W, C, NL = 60, 107, 256, 4
N_CONTEXT, LONG_MEM, TOPK, RADIUS, TEMP = 20, [0], 10, 12.0, 0.05
FP32_PEAK = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
BF16_PEAK = 989e12       # H100 SXM dense bf16 FLOP/s (tensor cores)
HBM_RATE = 3.35e12       # H100 SXM bytes/s
# bench.py's flagship training step
CLIP_LEN, N_PATCHES, PATCH, BATCH, WALK_TEMP, EDGEDROP = 8, 49, 64, 8, 0.05, 0.1
# reflect-conv kernels at the step's shapes: (tag, N, Cin, Cout, H, W)
RCONV_SHAPES = (("flagship", 3136, 512, 512, 8, 8),     # layer4 interior
                ("layer1", 3136, 64, 64, 16, 16),
                ("cin_ne_cout", 3136, 128, 256, 8, 8),  # layer3.0.conv1
                ("32x32", 196, 512, 512, 32, 32))       # the same pixels
# #5's moments against the f32 sums of a y, per channel: s1 within MOM_TOL
# of that channel's sum |y|, s2 within MOM_TOL of its sum y^2. "own": the
# kernel's own cast y (the same values summed in another order); "ref": the
# plain version's y (whose bf16 roundings may differ from the kernel's)
MOM_TOL = dict(own=1e-5, ref=2e-5)
RCONV = (("fwd", rc.reflect_conv_fwd), ("fwd_stats", rc.reflect_conv_fwd_stats),
         ("dx", rc.reflect_conv_dx), ("dw", rc.reflect_conv_dw))
# training arms: (rconv, bn_fuse) -> reflect-conv launches per step
ARMS = ((("off", "stats"), dict(fwd=0, fwd_stats=0, dx=0, dw=0)),
        (("auto", "stats"), dict(fwd=0, fwd_stats=3, dx=3, dw=3)),
        (("on", "stats"), dict(fwd=0, fwd_stats=15, dx=15, dw=15)),
        (("on", "off"), dict(fwd=15, fwd_stats=0, dx=15, dw=15)))


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


def kernel_vs_plain(n_targets: int = 4) -> dict:
    """Phase 2: kernel and plain version on the same label buffer."""
    rng = np.random.RandomState(0)
    N = N_CONTEXT + n_targets
    f = rng.randn(N, H, W, C).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    lab = np.zeros((N, H, W, NL), np.float32)
    lab[:N_CONTEXT + 1] = np.eye(NL, dtype=np.float32)[
        rng.randint(0, NL, (H, W))]
    feats = torch.from_numpy(f).cuda()
    buf = torch.from_numpy(lab).cuda()
    rows = context_index_bank(N_CONTEXT, LONG_MEM, n_targets)
    idx = torch.from_numpy(rows).cuda()
    kw = dict(n_long=len(LONG_MEM), topk=TOPK, temperature=TEMP,
              radius=RADIUS)
    errs = []
    for i in range(n_targets):
        t = int(rows[i, -1]) + 1
        got = ps.prop_sparse(feats, buf, idx[i], t, **kw)
        want = ps.prop_sparse_plain(feats, buf, idx[i], t, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"kernel output not finite at target {i}")
        errs.append((got - want).abs().max(-1).values.cpu().numpy())
        buf[t] = got.view(H, W, NL)     # both read the same buffer next step
    err = np.concatenate(errs)
    t_last = int(rows[-1, -1]) + 1
    ms = cuda_ms(lambda: ps.prop_sparse(feats, buf, idx[-1], t_last, **kw), 20)
    plain_ms = cuda_ms(
        lambda: ps.prop_sparse_plain(feats, buf, idx[-1], t_last, **kw), 3, 1)
    L = rows.shape[1]
    pairs = ps.valid_pairs(H, W, RADIUS, len(LONG_MEM), L - len(LONG_MEM))
    flops = 2.0 * C * pairs
    nbytes = 4.0 * ((L + 1) * H * W * C + L * H * W * NL + H * W * NL) + 4 * L
    res = dict(max_abs_err=float(err.max()), mean_abs_err=float(err.mean()),
               frac_over_1e4=float((err > 1e-4).mean()), ms=ms,
               plain_ms=plain_ms, pairs=pairs, gflop=flops / 1e9,
               ops_ms=flops / FP32_PEAK * 1e3, bytes_ms=nbytes / HBM_RATE * 1e3)
    res["bound_ms"] = max(res["ops_ms"], res["bytes_ms"])
    res["bound_by"] = "operations" if res["ops_ms"] >= res["bytes_ms"] \
        else "bytes"
    print(f"prop_sparse vs plain at DAVIS-480p ({n_targets} targets): "
          f"max|d| {res['max_abs_err']:.3e} mean|d| {res['mean_abs_err']:.3e} "
          f"cells |d|>1e-4 {res['frac_over_1e4']:.5f} (tolerance: |d| <= "
          f"1e-4 on >= 99.9% of cells)", flush=True)
    print(f"prop_sparse {ms:.3f} ms/target (median of 20), plain "
          f"{plain_ms:.3f} ms/target; bound {res['bound_ms']:.3f} ms "
          f"({res['gflop']:.1f} GFLOP f32 over {pairs} valid pairs)",
          flush=True)
    if res["frac_over_1e4"] > 1e-3:
        fail("kernel disagrees with its plain version on more than 0.1% "
             "of cells by more than 1e-4")
    return res


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


def _walk_inputs(B, T, N, C, rate, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, T, N, C), generator=g, device="cuda")
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
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


def walk_kernels_vs_plain() -> dict:
    """Phase 5: the walk kernels and their plain version on the same inputs,
    at the flagship shape and at the gate's edge. Tolerances: losses rtol
    1e-5, accuracies 1e-6, residuals rtol 1e-5 + atol 1e-6, dq 2e-5 of its
    largest entry (f32 products summed in another order)."""
    res = {}
    for tag, shape in (("flagship", (BATCH, CLIP_LEN, N_PATCHES, 128)),
                       ("edge", (BATCH, 10, 128, 512))):
        q, m12, m21, dl = _walk_inputs(*shape, rate=EDGEDROP, seed=4)
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
        if not (torch.isfinite(got[0]).all() and torch.isfinite(got_dq).all()
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
        wk.walk_fwd.launches, wk.walk_bwd.launches = before  # not the path's
        bounds = walk_bounds(*shape)
        res[tag] = dict(shape=shape, err=err, bounds=bounds, **times)
        print(f"walk kernels vs plain at {tag} (B,T,N,C)={shape}, edge-drop "
              f"rate {EDGEDROP}: max|d| losses {err['losses']:.3e} (rel "
              f"{err['loss_rel']:.2e}), accs {err['accs']:.1e}, residuals "
              f"{err['residuals']:.3e}, dq {err['dq']:.3e} of {err['dq_scale']:.3e} "
              f"(tolerance: losses rtol 1e-5, accs 1e-6, residuals rtol 1e-5 "
              f"+ 1e-6, dq 2e-5 of its largest entry)", flush=True)
        print(f"  fwd {times['fwd_ms']:.4f} ms (plain {times['plain_fwd_ms']:.4f}, "
              f"bound {bounds['fwd']['bound_ms']:.5f} by {bounds['fwd']['bound_by']})"
              f"; bwd {times['bwd_ms']:.4f} ms (plain {times['plain_bwd_ms']:.4f}, "
              f"bound {bounds['bwd']['bound_ms']:.5f} by {bounds['bwd']['bound_by']})",
              flush=True)
    return res


def rconv_counts() -> dict:
    return {name: f.launches for name, f in RCONV}


def set_rconv_counts(counts: dict) -> None:
    for name, f in RCONV:
        f.launches = counts[name]


def rconv_bounds(N, cin, cout, H, W, itemsize=2, peak=BF16_PEAK) -> dict:
    """Least times of the four kernels: each input read once and each
    output written once over the HBM rate, against the bf16 (or f32)
    multiply-adds over the peak; the moments add 2*Cout f32."""
    M = N * H * W
    flops = 2 * M * 9 * cin * cout
    wb, xb, yb = 9 * cin * cout * itemsize, M * cin * itemsize, M * cout * itemsize
    nbytes = dict(fwd=xb + wb + yb, fwd_stats=xb + wb + yb + 8 * cout,
                  dx=yb + wb + xb, dw=xb + yb + wb)
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


def rconv_kernels_vs_plain() -> dict:
    """The reflect-conv kernels #4, #5, #9, #10 against their plain version
    on the same bf16 inputs at the step's shapes, and their times.
    Tolerances, relative to each output's largest entry: y and dW 1e-2, dx
    2e-2 (each side rounds f32 sums to bf16, ~4e-3; the plain dx rounds the
    padded gradient before folding the pad back); moments per channel, as
    ``MOM_TOL`` states, against the kernel's own cast y and the plain y.
    Two planted faults (s1 zeroed; one forward tile of rows left out of
    both sums) must fail that check. ``plain_ms`` is the plain version as the wrapper would call it
    (forward: ``F.pad`` + ``conv2d``, + its f32 sums for the moments;
    backward: autograd of the same, dx and dW together); ``library_ms`` is
    the PyTorch calls of the same function: ``F.pad`` + cuDNN ``conv2d``
    forward (followed by the f32 sums of y and y^2 for the moments), and
    the autograd backward (dx and dW together) on a kept graph."""
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
        y_ref = rc.reflect_conv_plain(x, w)
        dx_ref, dw_ref = rc.reflect_conv_plain_bwd(x, w, gy)
        ys, s1, s2 = got["fwd_stats"]
        tile = ys.permute(0, 2, 3, 1).reshape(-1, cout)[
            :rc._lib().rconv_conv_bm(1)].float()
        faults = dict(s1_zeroed=(torch.zeros_like(s1), s2),
                      tile_left_out=(s1 - tile.sum(0),
                                     s2 - (tile * tile).sum(0)))
        torch.cuda.synchronize()

        def rel(a, b):
            return float((a.float() - b.float()).abs().max()
                         / b.float().abs().max())

        err = dict(fwd=rel(got["fwd"], y_ref), dx=rel(got["dx"], dx_ref),
                   dw=rel(got["dw"], dw_ref),
                   moments_own=moment_err(s1, s2, ys),
                   moments_ref=moment_err(s1, s2, y_ref),
                   planted={k: dict(own=moment_err(*f, ys),
                                    ref=moment_err(*f, y_ref))
                            for k, f in faults.items()},
                   y_stats_equal=bool(torch.equal(ys, got["fwd"])))
        m1, m2 = rc.moments_plain(y_ref)
        abs_err = dict(fwd=float((got["fwd"].float() - y_ref.float()).abs().max()),
                       fwd_stats=float(max((s1 - m1).abs().max(),
                                           (s2 - m2).abs().max())),
                       dx=float((got["dx"].float() - dx_ref.float()).abs().max()),
                       dw=float((got["dw"].float() - dw_ref.float()).abs().max()))
        ok = (err["fwd"] <= 1e-2 and err["dw"] <= 1e-2 and err["dx"] <= 2e-2
              and err["moments_own"] <= MOM_TOL["own"]
              and err["moments_ref"] <= MOM_TOL["ref"]
              and err["y_stats_equal"]
              and all(torch.isfinite(t).all() for t in
                      (got["fwd"], got["dx"], got["dw"], s1, s2)))
        print(f"reflect-conv kernels vs plain at {tag} (N,Cin,Cout,H,W)="
              f"{(N, cin, cout, H, W)} bf16: |d|/max y {err['fwd']:.2e}, dx "
              f"{err['dx']:.2e}, dW {err['dw']:.2e}; moments per channel "
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
        del got, y_ref, dx_ref, dw_ref, tile, faults
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
                yy, (xx, ww), gy, retain_graph=True), reps))
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
            lib = library.get(name, library["bwd"])
            print(f"  {name:9s} {times[name]:8.3f} ms (plain {p:8.3f}, library "
                  f"{lib:8.3f}, bound {bounds[name]['bound_ms']:.3f} by "
                  f"{bounds[name]['bound_by']})", flush=True)
        del x, w, gy
        torch.cuda.empty_cache()
    set_rconv_counts(saved)                 # comparison launches do not count
    return res


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


def profile_steps(state, step, batch, gen, n: int = 3) -> dict:
    """``n`` more steps under ``torch.profiler``: device time by kernel and
    by kind, and the device's idle share of the host clock's window (one
    stream, so kernel times add up)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, batch, gen)
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
        kind = ("walk kernels" if low.startswith("walk_") else
                "reflect-conv kernels" if ("rconv_gemm" in low
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
        res["profile"] = profile_steps(state, step, batch, gen)
    del state, batch
    torch.cuda.empty_cache()
    return res


def train_step_phase(n_steps: int) -> dict:
    """Phase 6: the flagship training step in four arms that differ only by
    the reflect-conv route, one after another in this process: the
    cuDNN path (``rconv='off'``), the default (``auto`` + ``stats``,
    profiled), every supported conv with moments (``on`` + ``stats``) and
    without (``on`` + ``off``)."""
    arms = {}
    for (rconv, bn_fuse), expect in ARMS:
        default = (rconv, bn_fuse) == ("auto", "stats")
        arms[f"{rconv}+{bn_fuse}"] = train_arm(rconv, bn_fuse, expect,
                                               n_steps, profile=default)
    print("A/B of the full step (same process, same seeds):", flush=True)
    for name, a in arms.items():
        print(f"  {name:12s} {a['step_ms']:8.2f} ms/step  "
              f"{a['clips_per_s']:6.2f} clips/s  MFU {100 * a['mfu']:5.2f}%  "
              f"{a['max_memory_gib']:6.2f} GiB", flush=True)
    return arms


def small_step_card_vs_cpu() -> dict:
    """Phase 7: one f32 forward/backward with every supported reflect conv
    routed (``rconv='on'``, ``bn_fuse='stats'``), card (kernels) vs CPU
    (plain versions), same weights, same 64 px clips, same edge-drop masks.
    Tolerances: loss rtol 1e-4 and q atol 1e-4 (f32 convolutions by
    different algorithms); gradients 2e-2 relative in L2 over all
    parameters (the early layers' f32 gradients are badly conditioned at
    random weights; the CPU tests measure the same spread against JAX and
    f64)."""
    B, T, N = 2, 4, 4
    cfg = CRWConfig(model_type="scratch", temperature=WALK_TEMP, rconv="on",
                    bn_fuse="stats")
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
    print(f"small f32 step (B,T,N)=({B},{T},{N}) {PATCH}px, rconv='on', card "
          f"vs CPU: loss {lc:.6f} vs {lh:.6f} (rel {res['loss_rel']:.2e}), q "
          f"max|d| {res['q_max_abs_err']:.2e}, grads rel L2 "
          f"{res['grad_rel_l2']:.2e} (tolerance: loss rtol 1e-4, q 1e-4, "
          f"grads 2e-2); kernel launches on the card {launched}", flush=True)
    if launched != dict(walk_fwd=1, walk_bwd=1, **ARMS[2][1]):
        fail("the card's small step did not go through the walk and the "
             "reflect-conv kernels")
    if not (res["loss_rel"] <= 1e-4 and res["q_max_abs_err"] <= 1e-4
            and res["grad_rel_l2"] <= 2e-2):
        fail("card and CPU training steps disagree")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--targets", type=int, default=40)
    ap.add_argument("--steps", type=int, default=10,
                    help="timed training steps (after 3 warm-up steps)")
    ap.add_argument("--out", default="", help="also write the results here")
    args = ap.parse_args()
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
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    kp = kernel_vs_plain()
    e2e = end_to_end(args.targets)
    small = small_card_vs_cpu()
    walk = walk_kernels_vs_plain()
    rconv = rconv_kernels_vs_plain()
    train = train_step_phase(args.steps)
    small_train = small_step_card_vs_cpu()

    kernels = [dict(
        name="prop_sparse_topk", route="cuda",
        source="videowalk_tpu_torch/ops/csrc/prop_sparse.cu",
        replaces="videowalk_tpu/ops/prop_sparse_kernel.py:67",
        launches=e2e["launches"], max_abs_err=kp["max_abs_err"], ms=kp["ms"],
        plain_ms=kp["plain_ms"], bound_ms=kp["bound_ms"],
        bound_by=kp["bound_by"], library_ms=None)]
    default = train["auto+stats"]
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
    # #4 runs on the route-on, BN-unfused path; #5, #9, #10 on the default
    rflag = rconv["flagship"]
    for name, line, arm in (("fwd", 224, "on+off"), ("fwd_stats", 291, "auto+stats"),
                            ("dx", 607, "auto+stats"), ("dw", 660, "auto+stats")):
        kernels.append(dict(
            name=f"reflect_conv_{name}", route="cuda",
            source="videowalk_tpu_torch/ops/csrc/rconv.cu",
            replaces=f"videowalk_tpu/ops/rconv_kernel.py:{line}",
            launches=train[arm]["launches"][name],
            max_abs_err=rflag["abs_err"][name], ms=rflag["ms"][name],
            plain_ms=rflag["plain_ms"].get(name, rflag["plain_ms"]["bwd"]),
            bound_ms=rflag["bounds"][name]["bound_ms"],
            bound_by=rflag["bounds"][name]["bound_by"],
            library_ms=rflag["library_ms"].get(name, rflag["library_ms"]["bwd"])))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(card=smi, build_s=build_s, kernel=kp,
                           end_to_end=e2e, small=small, walk=walk,
                           rconv=rconv, train=train, small_train=small_train,
                           kernels=kernels, ptxas=logs), fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
