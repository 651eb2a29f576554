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

``slic_fused`` is the wrapper (each call in the span ``slic``,
``utils/profile.py``): a CPU tensor takes ``slic``; a CUDA tensor
launches the hand-written Hopper kernels of ``csrc/slic.cu`` or raises.
``slic_fused.launches`` counts calls that went to the kernels, one a call;
``device_launches`` gives the device launches of a call: the features, then
one kernel a round (``1 + n_iter``; 11 at ``n_iter = 10``), one more with
``return_centers``. A call copies nothing from the host: the round kernel
gathers the grid centers itself, and the wrapper allocates every buffer on
the current stream.

The kernel takes the direct ``sum (f - c)^2``, the plain version the
expanded ``|f|^2 - 2 f.c + |c|^2``, whose terms of ~1e5 cancel to a few
units: labels can differ at near-ties, and k-means carries a difference
through its rounds. So the two are held to >= 99.9% equal labels for one
assignment from the same centers, and >= 99% for a full run on structured
frames. The kernel compares a pixel only with the centers whose window can
reach its 32x64 tile, and sums a round's clusters as int64 fixed point
(2^-20): labels and centers repeat bit for bit.

Bound on the card: f32 operations, ~14 for each (pixel, center in its
window) pair of each round (all active centers for a pixel with none in its
window), ~6 a pixel for each center update; input and output are 25 MB at
(6, 4, 256, 256, 3). See the source's note.
"""

from __future__ import annotations

import ctypes

import torch

from videowalk_tpu_torch.ops.slic_device import (check_slic_args,
                                                 grid_shape, slic,
                                                 slic_geometry)
from videowalk_tpu_torch.utils.profile import spanned

MAX_SEGMENTS = 128     # center slots the kernels take
FIX_SCALE = 2 ** 20    # the kernels' fixed point: int64 sums of feature * 2^20
COLOR_BOUND = 4096.0   # |Lab| or |100 * rgb| the fixed point leaves room for


def device_launches(n_iter: int, return_centers: bool = False) -> int:
    """Device launches of one ``slic_fused`` call on the card: the
    features, a round kernel a round, the centers' finalize."""
    return 1 + n_iter + int(return_centers)


def check_fixed_point_range(H: int, W: int, ratio: float) -> None:
    """Refuse frames whose int64 fixed-point sums could pass 2^62: ``H * W``
    pixels of features up to ``COLOR_BOUND`` (colors) and
    ``max(H, W) * ratio`` (positions)."""
    bound = H * W * max(COLOR_BOUND, max(H, W) * ratio) * FIX_SCALE
    if bound >= 2.0 ** 62:
        raise ValueError(f"slic_fused: {H}x{W} frames at ratio {ratio:.4g} "
                         f"pass the kernels' fixed-point range")


def _lib():
    from videowalk_tpu_torch.ops import _build

    lib = _build.load("slic")
    if lib.slic_launch.argtypes is None:
        lib.slic_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.slic_launch.restype = ctypes.c_int
    return lib


@spanned("slic")
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
    ratio, window = slic_geometry(H, W, n_segments, compactness)
    check_fixed_point_range(H, W, ratio)
    gh, gw = grid_shape(H, W, n_segments)
    K = n_segments
    rgb = images.detach().reshape(B, H * W, 3).float().contiguous()
    color = torch.empty((B, 3, H * W), dtype=torch.float32, device=dev)
    cbuf = torch.empty((2, B, K, 5), dtype=torch.float32, device=dev)
    ring = torch.empty((3, B, K, 6), dtype=torch.int64, device=dev)
    labels = torch.empty((B, H * W), dtype=torch.int32, device=dev)
    centers = (torch.empty((B, K, 5), dtype=torch.float32, device=dev)
               if return_centers else None)
    init = (None if init_centers is None
            else init_centers.detach().float().contiguous())
    if n_active is not None:
        n_active = n_active.contiguous()
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.slic_launch(
            rgb.data_ptr(), color.data_ptr(),
            None if init is None else init.data_ptr(),
            None if n_active is None else n_active.data_ptr(),
            cbuf.data_ptr(), ring.data_ptr(), labels.data_ptr(),
            None if centers is None else centers.data_ptr(), B, H, W, K,
            n_iter, int(convert_lab), float(ratio), float(window), gh, gw,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slic_fused kernel launch failed: cudaError {err}")
    slic_fused.launches += 1
    labels = labels.reshape(*lead, H, W)
    return (labels, centers) if return_centers else labels


slic_fused.launches = 0
