"""L1-ball (diamond) binary dilation of a stack of masks.

Replaces the Pallas TPU kernel ``videowalk_tpu/ops/dilation_kernel.py``
(``_dilate_kernel``, reached through ``dilate_l1_pallas``). For each mask
``n`` of ``(N, h, w)`` and radius ``r = kernel_size // 2``:

    out[n, y, x] = 1  iff  some set pixel (y', x') of mask n inside the frame
                           has |y - y'| + |x - x'| <= r

(the exact diamond dilation, zero outside the frame). There is no gradient:
the reference thresholds a grouped conv with ``> 0``, whose derivative is
zero almost everywhere, and the masks come from integer labels.

``dilate_l1`` is the wrapper: a CPU tensor takes ``dilate_l1_plain`` (the
JAX package's decomposition into two diagonal segment max-filters of
``O(log r)`` shifted maxes plus unit-diamond passes); a CUDA tensor launches
the hand-written Hopper kernel ``csrc/dilation.cu`` or raises.
``dilate_l1.launches`` counts kernel launches. The result is exact 0/1, so
kernel and plain version are held to equality.

Bound on the card: bytes, one read and one write of the stack. At the
superpixel step of record (1152 masks of 256x256 in bf16, k=55) that is
302 MB, 0.09 ms at 3.35 TB/s; the arithmetic (a few bit operations a
pixel) is far below the card's rate. The plain version moves the stack ~17
times through padded copies. The kernel takes a band of whole rows of one
mask a block (``choose_band``), reads it with its r-row halo once into
bit-packed rows in shared memory, dilates there and writes the band once
(see the source's note).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from videowalk_tpu_torch.core.masks import l1_decomposition

MAX_RADIUS = 127       # k up to 255: the radii held to the plain version
SMEM_LIMIT = 232448    # bytes of shared memory a block can take on Hopper
ROWS_BYTES = 64        # the kernel's set-row reduction: 2 ints a warp, 8 warps
_DTYPES = {torch.uint8: 0, torch.bfloat16: 1, torch.float32: 2}


def _pitch(w: int) -> int:
    return ((w + 31) // 32) | 1


def window_bytes(h: int, w: int, r: int, band: int) -> int:
    """Shared memory of a block of the kernel that takes ``band`` rows: two
    buffers of the band's window (``band + 2r`` rows, clipped at the frame),
    ``ceil(w / 32) | 1`` 32-bit words a row, and the set-row reduction
    (mirrors ``csrc/dilation.cu``, whose shared memory is all dynamic)."""
    return 2 * min(h, band + 2 * r) * _pitch(w) * 4 + ROWS_BYTES


def choose_band(h: int, w: int, r: int) -> int:
    """Rows a block of the kernel takes: the whole frame where its window
    fits the card's shared memory (``SMEM_LIMIT``), else the tallest band
    whose window fits. Raises where not even the window of one row fits,
    with the widest frame that does at this h and r."""
    if window_bytes(h, w, r, 1) > SMEM_LIMIT:
        words = (SMEM_LIMIT - ROWS_BYTES) // (8 * min(h, 1 + 2 * r))
        widest = 32 * (words if words % 2 else words - 1)
        raise ValueError(f"dilate_l1: width {w} does not fit the kernel at "
                         f"radius {r}: a band of one row needs "
                         f"{window_bytes(h, w, r, 1)} bytes of shared memory, "
                         f"the limit is {SMEM_LIMIT} (widths up to {widest})")
    if window_bytes(h, w, r, h) <= SMEM_LIMIT:
        return h
    return (SMEM_LIMIT - ROWS_BYTES) // (8 * _pitch(w)) - 2 * r


def _shift(y: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[..., r, c] = in[..., r - dy, c - dx]``, zero outside (a negative
    pad crops)."""
    return F.pad(y, (dx, -dx, dy, -dy))


def _segment_dilate(y, a: int, sy: int, sx: int):
    """Max over t in [-a, a] of the shift by ``t * (sy, sx)``: the doubling
    trick ``[0, n) = [0, 2^k) U [n - 2^k, n)``, then centred."""
    n = 2 * a + 1
    covered = 1
    while covered * 2 <= n:
        y = torch.maximum(y, _shift(y, covered * sy, covered * sx))
        covered *= 2
    if covered < n:
        d = n - covered
        y = torch.maximum(y, _shift(y, d * sy, d * sx))
    return _shift(y, -a * sy, -a * sx)


def unit_diamond(y):
    """L1 dilation of radius 1: the max over the pixel and its 4 neighbours."""
    return torch.maximum(
        torch.maximum(torch.maximum(_shift(y, 1, 0), _shift(y, -1, 0)),
                      torch.maximum(_shift(y, 0, 1), _shift(y, 0, -1))), y)


def dilate_l1_plain(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Plain PyTorch version for 0/1 masks ``(N, h, w)``: with
    ``E(a) = Seg45(a) + Seg135(a)`` the even-parity sublattice of the
    radius-2a diamond, ``D(2a+1) = E(a) + D(1)`` and
    ``D(2a) = E(a-1) + D(1) + D(1)``. The stack is zero-padded by r first: a
    diagonal path between two in-frame points may leave the frame."""
    r = kernel_size // 2
    if r < 1:
        return x
    h, w = x.shape[-2:]
    a, units = l1_decomposition(r)
    y = x
    if a > 0:
        y = F.pad(y, (r, r, r, r))
        y = _segment_dilate(y, a, 1, 1)
        y = _segment_dilate(y, a, 1, -1)
    for _ in range(units):
        y = unit_diamond(y)
    if a > 0:
        y = y[..., r:r + h, r:r + w]
    return y.contiguous()


def _lib():
    from videowalk_tpu_torch.ops import _build

    lib = _build.load("dilation")
    if lib.dilate_l1_launch.argtypes is None:
        lib.dilate_l1_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.dilate_l1_launch.restype = ctypes.c_int
    return lib


def dilate_l1(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """L1-ball dilation of 0/1 masks ``(N, h, w)`` (uint8, bf16 or f32),
    radius ``kernel_size // 2 >= 2``; returns the input's type. On the card
    any h, widths up to ``choose_band``'s limit (3616 at r=127). No autograd:
    the caller detaches."""
    r = kernel_size // 2
    if x.dim() != 3:
        raise ValueError(f"dilate_l1: masks must be (N, h, w); got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"dilate_l1: masks must be uint8, bfloat16 or "
                         f"float32; got {x.dtype}")
    if not 2 <= r <= MAX_RADIUS:
        raise ValueError(f"dilate_l1: radius {r} (kernel_size {kernel_size}) "
                         f"outside [2, {MAX_RADIUS}]")
    if x.device.type == "cpu":
        return dilate_l1_plain(x, kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"dilate_l1: unsupported device {x.device}")
    N, h, w = x.shape
    band = choose_band(h, w, r)
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _lib().dilate_l1_launch(
            x.data_ptr(), out.data_ptr(), N, h, w, r, _DTYPES[x.dtype], band,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dilate_l1 kernel launch failed: cudaError {err}")
    dilate_l1.launches += 1
    return out


dilate_l1.launches = 0
