"""Evaluation entry point: k-NN label propagation (counterpart of
``videowalk_tpu/cli/test.py``; reference ``code/test.py``).

Per video: encoder features in minibatches (an f32 trunk, or a bf16 one
under ``--encode-dtype bfloat16``, f32 features either way) -> L2 norm ->
context bank -> autoregressive propagation through the block-sparse kernel,
one launch per target frame -> dump blend jpg / mask png per target. A
filelist naming ``jhmdb`` reads ``JhmdbSet`` and also writes each video's
keypoints (``{vid_idx}.dat``); one naming ``VIP`` writes its masks under
``videos/`` as the dataset lays them out. ``--pca-vis`` writes PCA images
of every 10th frame's features under ``pca/``; ``--profile-dir`` writes a
``torch.profiler`` trace of one warm video (the second, or the only one)
there. A pretrained model type
(``imagenet18``, ``imagenet50``, ``moco50``, ``timecycle``, ``uvc``) loads
its encoder from ``--pretrained-path`` first; ``--resume`` loads over it.

    python -m videowalk_tpu_torch.cli.test --device cuda --filelist ... \\
        --model-type scratch --cropSize -1 --videoLen 20 --long-mem 0 \\
        --topk 10 --radius 12 --temperature 0.05 --resume model.pth
"""

from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from videowalk_tpu_torch.data.vos import IMAGENET_MEAN, IMAGENET_STD
from videowalk_tpu_torch.eval import test_utils
from videowalk_tpu_torch.eval.propagation import (context_index_bank,
                                                  propagate_labels)
from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.utils.arguments import check_supported
from videowalk_tpu_torch.utils.checkpoint import load_checkpoint, partial_load
from videowalk_tpu_torch.utils.device import resolve_device
from videowalk_tpu_torch.utils.pretrained import (PRETRAINED_TYPES,
                                                  apply_pretrained_encoder)
from videowalk_tpu_torch.utils.profile import Trace


def build_model(args, device: torch.device, seed: int = 0) -> CRW:
    """The CRW model in eval mode on ``device``, weights initialized from
    ``seed``, then, for a pretrained model type, its encoder from
    ``--pretrained-path`` (a checkpoint loaded afterwards overrides
    them)."""
    bf16 = getattr(args, "encode_dtype", "float32") == "bfloat16"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CRW(CRWConfig(model_type=args.model_type,
                              remove_layers=tuple(args.remove_layers),
                              head_depth=args.head_depth,
                              dtype=torch.bfloat16 if bf16 else torch.float32))
    if args.model_type in PRETRAINED_TYPES:
        path = getattr(args, "pretrained_path", "")
        apply_pretrained_encoder(model, args.model_type, path, verbose=False)
        print(f"Loaded pretrained {args.model_type} encoder from {path}",
              flush=True)
    return model.to(device).eval()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def encode_video(model: CRW, imgs: np.ndarray, batch_size: int = 5,
                 l2: bool = True) -> torch.Tensor:
    """Per-frame encoder features, minibatched.

    Args:
      imgs: (N, H, W, 3) frames: raw uint8 (normalized on the device in
        f32: ``(x / 255 - mean) / std``) or normalized float32.
    Returns:
      (N, C, H', W') f32 features (whatever the trunk's compute type) on the
      model's device, L2-normalized over C with ``max(norm, 1e-12)`` when
      ``l2``.
    """
    device = next(model.parameters()).device
    trunk = model.encoder.model
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)
    frames = torch.from_numpy(np.ascontiguousarray(imgs)).to(device)
    # f32 convolutions: cuDNN would otherwise take TF32
    flags = (torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
             if device.type == "cuda" else contextlib.nullcontext())
    feats = []
    with torch.inference_mode(), flags:
        for b in range(0, frames.shape[0], batch_size):
            x = frames[b:b + batch_size]
            if x.dtype == torch.uint8:
                x = (x.to(torch.float32) / 255.0 - mean) / std
            feats.append(trunk(x.permute(0, 3, 1, 2)).float())
        feats = torch.cat(feats)
        if l2:
            norm = torch.linalg.vector_norm(feats, dim=1, keepdim=True)
            feats = feats / torch.clamp(norm, min=1e-12)
    return feats


def dump_pca_vis(feats: np.ndarray, save_path: str, vid_idx: int) -> None:
    """``--pca-vis``: PCA images of every 10th frame's features, upsampled
    4x, as ``pca/{vid_idx}_{frame}.png``."""
    import imageio

    from videowalk_tpu_torch.utils.visualize import pca_feats

    pf = pca_feats(feats[::10])                  # (n, 3, H', W') in [0, 1]
    outdir = os.path.join(save_path, "pca")
    os.makedirs(outdir, exist_ok=True)
    for i, frame in enumerate(pf):
        img = (np.kron(frame.transpose(1, 2, 0), np.ones((4, 4, 1)))
               * 255).astype(np.uint8)
        imageio.imwrite(os.path.join(outdir, f"{vid_idx}_{i * 10}.png"), img)


def test(loader, model: CRW, args, dump=None, n_videos: int | None = None):
    """Evaluate every video of ``loader`` (tuples as ``VOSDataset`` yields
    them). ``dump(pred, lbl_map, img, outpath, img_is_unit_scale=False)`` is
    called per target frame (default ``test_utils.dump_predictions``).
    Returns one dict of counts and seconds per video (host clock, each phase
    ending in a device synchronize); on a JHMDB filelist it also holds the
    keypoints ``(2, J, targets)``. Under ``--profile-dir`` video 1 is
    traced where ``n_videos`` (or ``len(loader)``) says there are two or
    more, else video 0, so that the trace shows a warm video."""
    dump = dump or test_utils.dump_predictions
    device = next(model.parameters()).device
    if n_videos is None and hasattr(loader, "__len__"):
        n_videos = len(loader)
    profile_dir = getattr(args, "profile_dir", "")
    profile_vid = 1 if (n_videos or 0) > 1 else 0
    stats = []
    for vid_idx, item in enumerate(loader):
        trace = (Trace(profile_dir, f"test_video{vid_idx}", device)
                 if profile_dir and vid_idx == profile_vid else None)
        if trace is not None:
            trace.start()
        try:
            stats.append(_test_video(model, args, dump, vid_idx, *item))
        finally:
            if trace is not None:
                trace.stop()
    return stats


def _test_video(model: CRW, args, dump, vid_idx: int, imgs, imgs_orig,
                lbls_resize, _lbls, lbl_map, meta) -> dict:
    """One video of ``test``: its stats dict."""
    n_context = args.videoLen
    device = next(model.parameters()).device
    filelist = getattr(args, "filelist", "")
    pose = "jhmdb" in filelist.lower()
    N = imgs.shape[0]
    print(f"******* Vid {vid_idx} ({N} frames) *******", flush=True)
    _sync(device)
    t0 = time.perf_counter()
    feats = encode_video(model, imgs, l2=not args.no_l2)
    _sync(device)
    t_enc = time.perf_counter()
    print("computed features", t_enc - t0, flush=True)
    if getattr(args, "pca_vis", False):
        dump_pca_vis(feats.cpu().numpy(), args.save_path, vid_idx)

    key_indices = context_index_bank(n_context, list(args.long_mem),
                                     N - n_context)
    labels0 = lbls_resize.astype(np.float32)
    if args.norm_mask:
        # Reference quirk (test.py:156-164): the first target's
        # in-place min-max rescale mutates frame 0 inside the buffer;
        # normalizing buffer index 0 up front reproduces it, as the JAX
        # package does (+1e-12 avoids 0/0 on constant label rows)
        f0 = labels0[0] - labels0[0].min(-1, keepdims=True)
        labels0 = labels0.copy()
        labels0[0] = f0 / np.maximum(f0.max(-1, keepdims=True), 1e-12)
    preds = propagate_labels(
        feats, torch.from_numpy(labels0), key_indices,
        n_context=n_context, n_long=len(args.long_mem), topk=args.topk,
        temperature=args.temperature, radius=float(args.radius))
    preds = preds.cpu().numpy()            # synchronizes
    t_prop = time.perf_counter()
    print(t_prop - t_enc, "propagation (on-device)", flush=True)
    keypts = []
    with ThreadPoolExecutor(max_workers=2) as writers:
        futures = []
        for t in range(preds.shape[0]):
            pred = preds[t]
            if args.norm_mask:
                pred = pred - pred.min(-1, keepdims=True)
                pred = pred / np.maximum(pred.max(-1, keepdims=True),
                                         1e-12)
            frame = imgs_orig[t + n_context]     # uint8 or float in [0, 1]
            cur_img = frame if frame.dtype == np.uint8 else frame * 255
            if pose:
                keypts.append(test_utils.process_pose(pred, lbl_map)[0])
            if "VIP" in filelist:
                outpath = os.path.join(
                    args.save_path, "videos" + meta["img_paths"][
                        t + n_context].split("videos")[-1])
                os.makedirs(os.path.dirname(outpath), exist_ok=True)
            else:
                outpath = os.path.join(args.save_path, f"{vid_idx}_{t}")
            futures.append(writers.submit(
                dump, pred, lbl_map, cur_img, outpath,
                img_is_unit_scale=False))
        for f in futures:
            f.result()
    st = dict(frames=N, targets=int(preds.shape[0]))
    if keypts:
        st["keypoints"] = np.stack(keypts, axis=-1)
        st["keypoints"].dump(os.path.join(args.save_path,
                                          f"{vid_idx}.dat"))
    t_end = time.perf_counter()
    print(f"******* Vid {vid_idx} TOOK {t_end - t0} *******", flush=True)
    return dict(st, encode_s=t_enc - t0, propagate_s=t_prop - t_enc,
                total_s=t_end - t0)


def main(args):
    check_supported(args)
    device = resolve_device(getattr(args, "device", "cuda"))
    print("torch device:", device,
          torch.cuda.get_device_name(device) if device.type == "cuda" else "")
    model = build_model(args, device)
    args.mapScale = test_utils.infer_downscale(model.spec.map_scale)
    args.use_lab = args.model_type == "uvc"

    from videowalk_tpu_torch.data import jhmdb, vos

    dataset = (vos.VOSDataset if "jhmdb" not in args.filelist
               else jhmdb.JhmdbSet)(args)
    if args.resume and os.path.isfile(args.resume):
        print("==> Resuming from checkpoint..")
        ckpt = load_checkpoint(args.resume)
        partial_load(ckpt["model"], model, skip_keys=["head"])
    os.makedirs(args.save_path, exist_ok=True)
    return test((dataset[i] for i in range(len(dataset))), model, args,
                n_videos=len(dataset))


if __name__ == "__main__":
    from videowalk_tpu_torch.utils.arguments import test_args

    main(test_args())
