"""The one generator of the benchmark's inputs, steered by a traffic mix's
parameters and the run's seed. Every seed gives the same sizes (batch
shapes, video lengths, object counts); the seed picks the content and the
order.

- ``moving_textures``: clips of low-frequency color textures, each
  drifting by its own few pixels a frame, with a bright square crossing
  them: structure for SLIC to find, made on the device in a few calls.
- ``davis_videos``: videos at DAVIS's 480p with 1 to 5 textured objects
  moving over a drifting textured background, their first frame's labels
  at feature resolution (8x8 cell means of the one-hot ids, as the
  evaluator's resize of the annotation gives them)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _texture(gen, n: int, h: int, w: int, cell: int, device):
    """``(n, 3, h, w)`` smooth textures in [0, 1]: N(0, 1) on a grid of
    ``cell`` px, bilinearly upsampled."""
    gh, gw = math.ceil(h / cell) + 1, math.ceil(w / cell) + 1
    z = torch.randn((n, 3, gh, gw), generator=gen, device=device)
    z = F.interpolate(z, size=(h, w), mode="bilinear", align_corners=False)
    return (0.5 + 0.25 * z).clamp(0.0, 1.0)


def moving_textures(gen, B: int, T: int, size: int, cell: int,
                    device) -> torch.Tensor:
    """``(B, T, size, size, 3)`` f32 frames in [0, 1]."""
    tex = _texture(gen, B, 2 * size, 2 * size, cell, device)
    vel = torch.randint(1, 5, (B, 2), generator=gen, device=device).tolist()
    s = size // 6
    square = torch.tensor((230.0, 60.0, 40.0), device=device)[:, None,
                                                               None] / 255
    out = torch.empty((B, T, 3, size, size), device=device)
    for b, (vy, vx) in enumerate(vel):
        for t in range(T):
            y, x = (t * vy) % size, (t * vx) % size
            out[b, t] = tex[b, :, y:y + size, x:x + size]
            q = (t * 5) % (size - s)
            out[b, t, :, q:q + s, size // 3:size // 3 + s] = square
    return out.permute(0, 1, 3, 4, 2).contiguous()


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(unit: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=unit.device)
    std = torch.tensor(IMAGENET_STD, device=unit.device)
    return (unit - mean) / std


def patch_grid(frames: torch.Tensor, patch: int) -> torch.Tensor:
    """``(B, T, S, S, 3)`` -> ``(B, T, N, patch, patch, 3)``: the row-major
    grid of ``patch`` px windows at stride ``patch // 2`` (the trainer's
    ``--frame-aug grid``)."""
    B, T, S = frames.shape[:3]
    stride = patch // 2
    tiles = frames.unfold(2, patch, stride).unfold(3, patch, stride)
    n = tiles.shape[2]
    return tiles.permute(0, 1, 2, 3, 5, 6, 4).reshape(B, T, n * n, patch,
                                                      patch, 3)


def davis_video(gen, n_frames: int, n_objects: int, h: int, w: int,
                cell: int, device):
    """One video: uint8 frames ``(n_frames, h, w, 3)`` and frame 0's
    one-hot labels ``(ceil(h/8), ceil(w/8), n_objects + 1)`` f32."""
    bg = _texture(gen, 1, h + 2 * n_frames, w + 2 * n_frames, cell,
                  device)[0]
    obj_tex = _texture(gen, n_objects, h, w, max(4, cell // 3), device)
    par = torch.rand((n_objects, 6), generator=gen, device=device).tolist()
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    vb = torch.randint(-1, 2, (2,), generator=gen, device=device).tolist()
    frames = torch.empty((n_frames, 3, h, w), device=device)
    ids0 = None
    for t in range(n_frames):
        oy, ox = n_frames + vb[0] * t, n_frames + vb[1] * t
        frame = bg[:, oy:oy + h, ox:ox + w].clone()
        ids = torch.zeros((h, w), dtype=torch.int64, device=device)
        for k in range(n_objects):
            cy0, cx0, ry, rx, vy, vx = par[k]
            cy = (cy0 * 0.6 + 0.2) * h + (vy - 0.5) * 4 * t
            cx = (cx0 * 0.6 + 0.2) * w + (vx - 0.5) * 6 * t
            ay, ax = (0.08 + 0.12 * ry) * h, (0.06 + 0.1 * rx) * w
            inside = ((yy - cy) / ay) ** 2 + ((xx - cx) / ax) ** 2 < 1.0
            frame = torch.where(inside, obj_tex[k], frame)
            ids = torch.where(inside, k + 1, ids)
        frames[t] = frame
        if t == 0:
            ids0 = ids
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    onehot = F.one_hot(ids0, n_objects + 1).to(torch.float32)
    onehot = F.pad(onehot.permute(2, 0, 1)[None], (0, wp - w, 0, hp - h),
                   mode="replicate")[0]
    labels = F.avg_pool2d(onehot, 8).permute(1, 2, 0)
    u8 = (frames * 255).round().clamp(0, 255).to(torch.uint8)
    return (u8.permute(0, 2, 3, 1).cpu().numpy(),
            labels.contiguous().cpu().numpy())


def video_item(frames: np.ndarray, labels0: np.ndarray, n_context: int):
    """The evaluator's item for one video (``data/vos.py``'s tuple at
    ``--cropSize -1``): ``n_context`` copies of frame 0 first, the labels
    of frame 0 for those copies (later entries are predictions), the
    label set, no metadata."""
    imgs = np.concatenate([np.repeat(frames[:1], n_context, 0), frames])
    lbls = np.repeat(labels0[None], len(imgs), 0)
    n_l = labels0.shape[-1]
    lblset = np.stack([np.arange(n_l)] * 3, -1).astype(np.uint8)
    return imgs, imgs, lbls, None, lblset, {}
