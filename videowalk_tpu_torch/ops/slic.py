"""Fused SLIC superpixels: the whole segmentation without the distance
tensor.

Replaces the Pallas TPU kernel ``videowalk_tpu/ops/slic_kernel.py``
(``_slic_frame_kernel``, reached through ``slic_fused``). Same signature and
contract as ``ops.slic_device.slic``, its plain version: Lab + scaled
``(y, x)`` features, ``n_iter`` rounds of windowed nearest-center assignment
(ties to the lowest slot; a pixel with no in-window center takes the
unwindowed nearest; slots ``>= n_active`` never win) and center means (an
empty cluster keeps its center), int32 labels of the last assignment.

Rounds: like ``slic`` (the backend that training deploys, JAX
``ops/slic_device.slic``), ``n_iter`` means ``n_iter`` assignments with
``n_iter - 1`` center updates between them. The Pallas body updates after each
of its ``n_iter`` assignments and then assigns once more (``n_iter + 1``
assignments, ``n_iter`` updates): the JAX ``slic_fused`` at ``n_iter`` is this
function at ``n_iter + 1``. The port keeps one meaning of ``n_iter`` for the
CPU and the card; ``tests/test_torch_slic.py`` holds it to both JAX functions.

``slic_fused`` is the wrapper: a CPU tensor takes ``slic``; a CUDA tensor
launches the hand-written Hopper kernels of ``csrc/slic.cu`` or raises.
``slic_fused.launches`` counts calls that went to the kernels; one call
makes ``1 + n_iter + (n_iter - 1)`` device launches (features, then an
assignment and a center update a round; 20 at ``n_iter = 10``), one more
with ``return_centers``. Only the grid centers' colors are gathered in
PyTorch (one index of ``K`` pixels a frame).

The kernel takes the direct ``sum (f - c)^2``, the plain version the
expanded ``|f|^2 - 2 f.c + |c|^2``, whose terms of ~1e5 cancel to a few
units: labels can differ at near-ties, and k-means carries a difference
through its rounds. So the two are held to >= 99.9% equal labels for one
assignment from the same centers, and >= 99% for a full run on structured
frames. The sums are taken in a fixed order: labels repeat bit for bit.

Bound on the card: f32 operations, ~14 for each (pixel, active center) pair
of each round (24 frames of 256x256, 36 centers, 10 rounds: ~8 GFLOP, 0.12
ms at 67 TFLOP/s); input and output are 25 MB. See the source's note.
"""

from __future__ import annotations

import ctypes

import torch

from videowalk_tpu_torch.ops.slic_device import (check_slic_args,
                                                 initial_centers, slic,
                                                 slic_geometry)

MAX_SEGMENTS = 128     # center slots the kernels take


def _lib():
    from videowalk_tpu_torch.ops import _build

    lib = _build.load("slic")
    if lib.slic_rounds_launch.argtypes is None:
        lib.slic_features_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.slic_features_launch.restype = ctypes.c_int
        lib.slic_rounds_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.slic_rounds_launch.restype = ctypes.c_int
    return lib


def slic_fused(images: torch.Tensor, n_segments: int = 36,
               compactness: float = 50.0, n_iter: int = 10,
               convert_lab: bool = True, n_active=None,
               init_centers: torch.Tensor | None = None,
               return_centers: bool = False):
    """Fused-kernel SLIC; arguments and results as ``ops.slic_device.slic``
    (``images (..., H, W, 3)`` floats in [0, 1] -> ``(..., H, W)`` int32
    labels), with at most 128 segments."""
    kw = dict(n_segments=n_segments, compactness=compactness, n_iter=n_iter,
              convert_lab=convert_lab, n_active=n_active,
              init_centers=init_centers, return_centers=return_centers)
    if images.device.type == "cpu":
        return slic(images, **kw)
    if images.device.type != "cuda":
        raise ValueError(f"slic_fused: unsupported device {images.device}")
    if n_segments > MAX_SEGMENTS:
        raise ValueError(f"slic_fused: the CUDA kernels take at most "
                         f"{MAX_SEGMENTS} segments; got {n_segments}")
    B, n_active = check_slic_args(images, n_segments, n_iter, n_active,
                                  init_centers)
    lead = images.shape[:-3]
    H, W = images.shape[-3], images.shape[-2]
    dev = images.device
    if B == 0 or H * W == 0 or B > 65535:
        raise ValueError(f"slic_fused: {B} frames of {H}x{W}")
    rgb = images.detach().reshape(B, H * W, 3).float().contiguous()
    color = torch.empty_like(rgb)
    scratch = torch.empty((B, H * W), dtype=torch.uint8, device=dev)
    labels = torch.empty((B, H * W), dtype=torch.int32, device=dev)
    if n_active is not None:
        n_active = n_active.contiguous()
    ratio, window = slic_geometry(H, W, n_segments, compactness)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.slic_features_launch(rgb.data_ptr(), color.data_ptr(),
                                       B * H * W, int(convert_lab), stream)
        if err == 0:
            centers = (initial_centers(color, H, W, n_segments, ratio)
                       if init_centers is None
                       else init_centers.detach().float().clone()).contiguous()
            err = lib.slic_rounds_launch(
                color.data_ptr(), centers.data_ptr(),
                None if n_active is None else n_active.data_ptr(),
                scratch.data_ptr(), labels.data_ptr(), B, H, W, n_segments,
                n_iter, int(return_centers), float(ratio), float(window),
                stream)
    if err != 0:
        raise RuntimeError(f"slic_fused kernel launch failed: cudaError {err}")
    slic_fused.launches += 1
    labels = labels.reshape(*lead, H, W)
    return (labels, centers) if return_centers else labels


slic_fused.launches = 0
