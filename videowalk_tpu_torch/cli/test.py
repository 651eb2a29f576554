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
there and prints the table of its spans (``video``, ``encode``,
``labels``, ``propagate``, ``dump``). A pretrained model type
(``imagenet18``, ``imagenet50``, ``moco50``, ``timecycle``, ``uvc``) loads
its encoder from ``--pretrained-path`` first; ``--resume`` loads over it.

    python -m videowalk_tpu_torch.cli.test --device cuda --filelist ... \\
        --model-type scratch --cropSize -1 --videoLen 20 --long-mem 0 \\
        --topk 10 --radius 12 --temperature 0.05 --resume model.pth

``--data-parallel`` uses every visible card of the host: the model is
replicated on each, every encode chunk's frames split across them, and
each target's propagation runs in tile-row bands across them (bitwise the
one-card result). ``--distributed`` (``torchrun --nproc-per-node N``, or
``--coordinator-address HOST:PORT --num-processes N --process-id I``)
splits the video list: process r evaluates videos r, r + N, ... into the
shared ``--save-path`` under their global indices, then waits for the
others (on success only).
"""

from __future__ import annotations

import contextlib
import copy
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from videowalk_tpu_torch.data.vos import IMAGENET_MEAN, IMAGENET_STD
from videowalk_tpu_torch.eval import test_utils
from videowalk_tpu_torch.eval.propagation import (context_index_bank,
                                                  propagate_labels)
from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.ops.prop_sparse import TQ, sparse_shard_count
from videowalk_tpu_torch.parallel import multihost
from videowalk_tpu_torch.utils.arguments import check_supported
from videowalk_tpu_torch.utils.checkpoint import load_checkpoint, partial_load
from videowalk_tpu_torch.utils.device import resolve_device
from videowalk_tpu_torch.utils.pretrained import (PRETRAINED_TYPES,
                                                  apply_pretrained_encoder)
from videowalk_tpu_torch.utils.profile import Trace, timed


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


def replicate_model(model: CRW, devices) -> list:
    """``model`` on each of ``devices``: itself on its own device, a copy
    of its present weights on any other."""
    home = next(model.parameters()).device
    return [model if torch.device(d) == home
            else copy.deepcopy(model).to(d) for d in devices]


def encode_video(model: CRW, imgs: np.ndarray, batch_size: int = 5,
                 l2: bool = True, replicas=None) -> torch.Tensor:
    """Per-frame encoder features, minibatched.

    Args:
      imgs: (N, H, W, 3) frames: raw uint8 (normalized on the device in
        f32: ``(x / 255 - mean) / std``) or normalized float32.
      replicas: ``--data-parallel``'s ``replicate_model(model, devices)``:
        each chunk grows to ``batch_size * len(replicas)`` frames, split
        across them, the features gathered in order on ``model``'s device.
    Returns:
      (N, C, H', W') f32 features (whatever the trunk's compute type) on the
      model's device, L2-normalized over C with ``max(norm, 1e-12)`` when
      ``l2``.
    """
    device = next(model.parameters()).device
    models = replicas or [model]
    frames = torch.from_numpy(np.ascontiguousarray(imgs)).to(device)
    # f32 convolutions: cuDNN would otherwise take TF32
    flags = (torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
             if device.type == "cuda" else contextlib.nullcontext())
    feats = []
    with torch.inference_mode(), flags:
        for b in range(0, frames.shape[0], batch_size * len(models)):
            for j, m in enumerate(models):
                lo = b + j * batch_size
                if lo < frames.shape[0]:
                    feats.append(_encode_chunk(
                        m, frames[lo:lo + batch_size]).to(device))
        feats = torch.cat(feats)
        if l2:
            norm = torch.linalg.vector_norm(feats, dim=1, keepdim=True)
            feats = feats / torch.clamp(norm, min=1e-12)
    return feats


def _encode_chunk(model: CRW, x: torch.Tensor) -> torch.Tensor:
    """The trunk's f32 features of frames ``x`` on the model's device."""
    dev = next(model.parameters()).device
    x = x.to(dev)
    if x.dtype == torch.uint8:
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
        x = (x.to(torch.float32) / 255.0 - mean) / std
    return model.encoder.model(x.permute(0, 3, 1, 2)).float()


def dump_pca_vis(feats: np.ndarray, save_path: str, vid_idx: int) -> None:
    """``--pca-vis``: PCA images of every 10th frame's features, upsampled
    4x, as ``pca/{vid_idx}_{frame}.png``."""
    from PIL import Image

    from videowalk_tpu_torch.utils.visualize import pca_feats

    pf = pca_feats(feats[::10])                  # (n, 3, H', W') in [0, 1]
    outdir = os.path.join(save_path, "pca")
    os.makedirs(outdir, exist_ok=True)
    for i, frame in enumerate(pf):
        img = (np.kron(frame.transpose(1, 2, 0), np.ones((4, 4, 1)))
               * 255).astype(np.uint8)
        Image.fromarray(img).save(
            os.path.join(outdir, f"{vid_idx}_{i * 10}.png"))


def test(loader, model: CRW, args, dump=None, n_videos: int | None = None,
         video_indices=None, devices=None):
    """Evaluate every video of ``loader`` (tuples as ``VOSDataset`` yields
    them). ``dump(pred, lbl_map, img, outpath, img_is_unit_scale=False)`` is
    called per target frame (default ``test_utils.dump_predictions``).
    Returns one dict of counts and seconds per video; on a JHMDB filelist
    it also holds the keypoints ``(2, J, targets)``. The seconds are the
    host clocks of ``_test_video``'s spans (``utils/profile.py``), each
    phase ending in a device synchronize: ``encode_s`` the ``encode``
    span, ``propagate_s`` ``pca_vis`` (with ``--pca-vis``), ``labels``
    and ``propagate``, ``total_s`` the ``video``. Under ``--profile-dir``
    video 1 is traced where ``n_videos`` (or ``len(loader)``) says there are two or
    more, else video 0, so that the trace shows a warm video.

    ``video_indices``: the global index of each of ``loader``'s videos
    (``--distributed``'s stride), which names its outputs. ``devices``:
    ``--data-parallel``'s cards: the model is replicated on each of them
    once (``replicate_model``) for ``encode_video``, and
    ``propagate_labels`` bands over them."""
    dump = dump or test_utils.dump_predictions
    device = next(model.parameters()).device
    if n_videos is None and hasattr(loader, "__len__"):
        n_videos = len(loader)
    profile_dir = getattr(args, "profile_dir", "")
    profile_vid = 1 if (n_videos or 0) > 1 else 0
    if video_indices is not None:
        profile_vid = (video_indices[1] if len(video_indices) > 1
                       else (video_indices[0] if video_indices else -1))
    ids = iter(video_indices) if video_indices is not None else None
    replicas = replicate_model(model, devices) if devices else None
    stats = []
    for i, item in enumerate(loader):
        vid_idx = i if ids is None else next(ids)
        trace = (Trace(profile_dir, f"test_video{vid_idx}", device)
                 if profile_dir and vid_idx == profile_vid else None)
        if trace is not None:
            trace.start()
        try:
            stats.append(_test_video(model, args, dump, vid_idx, *item,
                                     devices=devices, replicas=replicas))
        finally:
            if trace is not None:
                trace.stop()
    return stats


def _test_video(model: CRW, args, dump, vid_idx: int, imgs, imgs_orig,
                lbls_resize, _lbls, lbl_map, meta, devices=None,
                replicas=None) -> dict:
    """One video of ``test``: its stats dict. Spans: ``video`` (a root
    span; counts: frames, targets) holds ``encode`` (to the features'
    synchronize), ``pca_vis`` (``--pca-vis``'s images), ``labels`` (the
    label buffer made and on the device, up to the first propagation
    launch), ``propagate`` (until the predictions are on the host) and
    ``dump`` (the targets' outputs, to the video's end)."""
    n_context = args.videoLen
    device = next(model.parameters()).device
    filelist = getattr(args, "filelist", "")
    pose = "jhmdb" in filelist.lower()
    N = imgs.shape[0]
    print(f"******* Vid {vid_idx} ({N} frames) *******", flush=True)
    _sync(device)
    with timed("video", root=True, frames=N) as video:
        with timed("encode") as encode:
            feats = encode_video(model, imgs, l2=not args.no_l2,
                                 replicas=replicas)
            _sync(device)
        print("computed features", encode.seconds, flush=True)
        pca_s = 0.0
        if getattr(args, "pca_vis", False):
            with timed("pca_vis") as pca:
                dump_pca_vis(feats.cpu().numpy(), args.save_path, vid_idx)
            pca_s = pca.seconds
        with timed("labels") as labels:
            key_indices = context_index_bank(n_context, list(args.long_mem),
                                             N - n_context)
            labels0 = lbls_resize.astype(np.float32)
            if args.norm_mask:
                # Reference quirk (test.py:156-164): the first target's
                # in-place min-max rescale mutates frame 0 inside the
                # buffer; normalizing buffer index 0 up front reproduces
                # it, as the JAX package does (+1e-12 avoids 0/0 on
                # constant label rows)
                f0 = labels0[0] - labels0[0].min(-1, keepdims=True)
                labels0 = labels0.copy()
                labels0[0] = f0 / np.maximum(f0.max(-1, keepdims=True),
                                             1e-12)
            if devices:
                n_bands = sparse_shard_count(feats.shape[2], TQ,
                                             len(devices))
                print(f"propagation sharded: {n_bands} active bands over "
                      f"{len(devices)} devices", flush=True)
            labels0 = torch.from_numpy(labels0).to(device)
        with timed("propagate") as propagate:
            preds = propagate_labels(
                feats, labels0, key_indices, n_context=n_context,
                n_long=len(args.long_mem), topk=args.topk,
                temperature=args.temperature, radius=float(args.radius),
                devices=devices)
            preds = preds.cpu().numpy()            # synchronizes
        propagate_s = pca_s + labels.seconds + propagate.seconds
        print(propagate_s, "propagation (on-device)", flush=True)
        video.add(targets=int(preds.shape[0]))
        with timed("dump"):
            keypoints = _dump_video(args, dump, vid_idx, preds, imgs_orig,
                                    lbl_map, meta, n_context, pose, filelist)
    print(f"******* Vid {vid_idx} TOOK {video.seconds} *******", flush=True)
    return dict(frames=N, targets=int(preds.shape[0]), **keypoints,
                encode_s=encode.seconds, propagate_s=propagate_s,
                total_s=video.seconds)


def _dump_video(args, dump, vid_idx: int, preds: np.ndarray, imgs_orig,
                lbl_map, meta, n_context: int, pose: bool,
                filelist: str) -> dict:
    """``_test_video``'s outputs: each target through ``dump`` (in a pool
    of two writers), and a JHMDB video's keypoints (returned, and dumped
    as ``{vid_idx}.dat``)."""
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
    if not keypts:
        return {}
    kp = np.stack(keypts, axis=-1)
    kp.dump(os.path.join(args.save_path, f"{vid_idx}.dat"))
    return dict(keypoints=kp)


def data_parallel_devices(args, device: torch.device):
    """``--data-parallel``'s cards: every visible one where the host has
    more than one and this process is not one rank of ``--distributed``
    (which takes one card a process), else None (one device, as the JAX
    eval without a mesh)."""
    if (not getattr(args, "data_parallel", False)
            or getattr(args, "distributed", False) or device.type != "cuda"
            or torch.cuda.device_count() < 2):
        return None
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def main(args):
    check_supported(args)
    world = multihost.initialize_from_args(args)
    try:
        return _main(args, world)
    finally:
        multihost.shutdown()


def _main(args, world: int):
    rank = multihost.rank()
    device = resolve_device(multihost.local_device(
        getattr(args, "device", "cuda")) if world > 1
        else getattr(args, "device", "cuda"))
    print("torch device:", device,
          torch.cuda.get_device_name(device) if device.type == "cuda" else "")
    model = build_model(args, device)
    devices = data_parallel_devices(args, device)
    if devices:
        print(f"eval data-parallel over {len(devices)} devices", flush=True)
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
    indices = list(range(rank, len(dataset), world))
    if world > 1:
        print(f"process {rank}/{world}: evaluating {len(indices)} of "
              f"{len(dataset)} videos {indices}", flush=True)
    stats = test((dataset[i] for i in indices), model, args,
                 n_videos=len(dataset),
                 video_indices=indices if world > 1 else None,
                 devices=devices)
    if world > 1:
        # the shards end at other times: no rank leaves (and takes the
        # group down) while another is mid-video; on success only
        torch.distributed.barrier()
    return stats


if __name__ == "__main__":
    from videowalk_tpu_torch.utils.arguments import test_args

    main(test_args())
