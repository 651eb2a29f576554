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
6. Drives the training slice: ``bench.py``'s flagship step (8-frame clips,
   batch 8, a 7x7 grid of 64 px patches, the ``scratch`` ResNet-18 with a
   bf16 trunk in BN-train mode, edge dropout 0.1, T 0.05, Adam lr 3e-4)
   from a seeded init through ``make_train_step``: a few warm-up steps,
   then ``--steps`` timed ones, with the walk kernels' launch counts zeroed
   just before and read just after. Every loss must be finite and each
   kernel launched once per step. Then 3 more steps under
   ``torch.profiler``: device time by kernel and kind, idle share.
7. A small f32 step on the card against the same step on the CPU (plain
   versions), same weights and edge-drop masks: loss and gradients.

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


def train_step_phase(n_steps: int, n_warmup: int = 3) -> dict:
    """Phase 6: the flagship training step, ``bench.py``'s config."""
    dev = torch.device("cuda")
    cfg = CRWConfig(model_type="scratch", temperature=WALK_TEMP,
                    edgedrop_rate=EDGEDROP, dtype=torch.bfloat16)
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
    t0 = time.perf_counter()
    metrics = [step(state, batch, gen) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_steps
    launches = (wk.walk_fwd.launches, wk.walk_bwd.launches)
    losses = [float(m["loss"]) for m in metrics]
    if launches != (n_steps, n_steps):
        fail(f"walk kernels launched {launches} times in {n_steps} steps")
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    flops = 3 * conv_fwd_flops_per_image() * BATCH * CLIP_LEN * N_PATCHES
    res = dict(steps=n_steps, step_ms=dt * 1e3, clips_per_s=BATCH / dt,
               tflop_per_step=flops / 1e12, mfu=flops / dt / BF16_PEAK,
               max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               losses=losses, walk_fwd_launches=launches[0],
               walk_bwd_launches=launches[1], state_step=state.step,
               acc_last={k: float(v) for k, v in metrics[-1].items()
                         if k.startswith("acc")})
    print(f"training step, bench.py config (batch {BATCH}, {CLIP_LEN} frames, "
          f"{N_PATCHES}x{PATCH}px patches, bf16 trunk): {res['step_ms']:.2f} "
          f"ms/step over {n_steps} steps, {res['clips_per_s']:.2f} clips/s, "
          f"{res['tflop_per_step']:.2f} TFLOP/step (analytic convs), MFU "
          f"{100 * res['mfu']:.2f}% of {BF16_PEAK / 1e12:.0f} TFLOP/s bf16; "
          f"peak memory {res['max_memory_gib']:.2f} GiB; losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}; walk launches {launches}",
          flush=True)
    # 3 more steps under the profiler, after the path's counts were read
    res["profile"] = profile_steps(state, step, batch, gen)
    return res


def small_step_card_vs_cpu() -> dict:
    """Phase 7: one f32 forward/backward, card (kernels) vs CPU (plain
    versions), same weights, same clips, same edge-drop masks. Tolerances:
    loss rtol 1e-4 and q atol 1e-4 (f32 convolutions by different
    algorithms); gradients 2e-2 relative in L2 over all parameters (the
    early layers' f32 gradients are badly conditioned at random weights;
    the CPU tests measure the same spread against JAX and f64)."""
    B, T, N = 2, 4, 4
    cfg = CRWConfig(model_type="scratch", temperature=WALK_TEMP)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(B, T, N, 32, 32, 3).astype(np.float32))
    masks = [torch.from_numpy(rng.rand(B, T - 1, N, N) < EDGEDROP)
             for _ in range(2)]
    out = {}
    before = (wk.walk_fwd.launches, wk.walk_bwd.launches)
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        model = seeded_crw(cfg, seed=3).to(dev)
        q, loss, _ = model(x.to(dev), train=True,
                           walk_masks=[m.to(dev) for m in masks])
        loss.backward()
        out[name] = (q.detach().cpu(), float(loss.detach()),
                     {k: p.grad.cpu() for k, p in model.named_parameters()})
    launched = (wk.walk_fwd.launches - before[0],
                wk.walk_bwd.launches - before[1])
    wk.walk_fwd.launches, wk.walk_bwd.launches = before  # not the path's
    (qc, lc, gc), (qh, lh, gh) = out["cuda"], out["cpu"]
    num = sum(float(((gc[k] - gh[k]) ** 2).sum()) for k in gh)
    den = sum(float((gh[k] ** 2).sum()) for k in gh)
    res = dict(loss_cuda=lc, loss_cpu=lh, loss_rel=abs(lc - lh) / abs(lh),
               q_max_abs_err=float((qc - qh).abs().max()),
               grad_rel_l2=(num / den) ** 0.5, kernel_launches=launched)
    print(f"small f32 step (B,T,N)=({B},{T},{N}) 32px, card vs CPU: loss "
          f"{lc:.6f} vs {lh:.6f} (rel {res['loss_rel']:.2e}), q max|d| "
          f"{res['q_max_abs_err']:.2e}, grads rel L2 {res['grad_rel_l2']:.2e} "
          f"(tolerance: loss rtol 1e-4, q 1e-4, grads 2e-2); walk kernel "
          f"launches on the card {launched}", flush=True)
    if launched != (1, 1):
        fail("the card's small step did not go through the walk kernels")
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
    train = train_step_phase(args.steps)
    small_train = small_step_card_vs_cpu()

    kernels = [dict(
        name="prop_sparse_topk", route="cuda",
        source="videowalk_tpu_torch/ops/csrc/prop_sparse.cu",
        replaces="videowalk_tpu/ops/prop_sparse_kernel.py:67",
        launches=e2e["launches"], max_abs_err=kp["max_abs_err"], ms=kp["ms"],
        plain_ms=kp["plain_ms"], bound_ms=kp["bound_ms"],
        bound_by=kp["bound_by"], library_ms=None)]
    flag = walk["flagship"]
    for d, line, err in (("fwd", 70, flag["err"]["losses"]),
                         ("bwd", 118, flag["err"]["dq"])):
        kernels.append(dict(
            name=f"walk_{d}", route="cuda",
            source="videowalk_tpu_torch/ops/csrc/walk.cu",
            replaces=f"videowalk_tpu/ops/walk_kernel.py:{line}",
            launches=train[f"walk_{d}_launches"], max_abs_err=err,
            ms=flag[f"{d}_ms"], plain_ms=flag[f"plain_{d}_ms"],
            bound_ms=flag["bounds"][d]["bound_ms"],
            bound_by=flag["bounds"][d]["bound_by"], library_ms=None))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(card=smi, build_s=build_s, kernel=kp,
                           end_to_end=e2e, small=small, walk=walk,
                           train=train, small_train=small_train,
                           kernels=kernels, ptxas=logs), fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
