"""Host superpixel segmentation: SLIC / Felzenszwalb per video frame
(counterpart of ``videowalk_tpu/data/superpixels.py``; reference
``code/data/superpixels.py``).

- ``compute_sp_slic``  <-> :9-15 (cv2 min-max normalize to uint8 -> SLIC)
- ``compute_sp_FH``    <-> :18-20 (felzenszwalb scale=600 sigma=0.5 min 400)
- ``compute_mask``     <-> :23-63 (per-frame loop, 'random' method choice,
  randomized segment counts, 3-channel replication)
- ``host_sp_mask``: a dataset item's ids, the one place ``Kinetics400``,
  ``ImageFolder`` and ``chip_smoke.py`` make them.

The C++ library (``native/superpixels.cc``, built with g++ at first use) is
the fast path; a numpy SLIC is the explicit ``backend="numpy"`` and the
tests' oracle. cv2 is used where it is installed and imported at first use;
without it (the card's machine has none) the same results come from
numpy: ``_normalize_uint8`` is bitwise ``cv2.normalize``'s, the Lab
conversion is ``ops/slic_device.rgb_to_lab`` on the CPU and the FH blur is
``cv2.GaussianBlur``'s 5-tap kernel with reflect-101 borders.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None


def _cv2():
    """cv2 where it is installed, else None (imported at first use)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _native():
    global _lib
    if _lib is None:
        from videowalk_tpu_torch.native import build_and_load

        lib = build_and_load("superpixels")
        lib.slic_segment.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]
        lib.slic_segment.restype = None
        lib.felzenszwalb_segment.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        lib.felzenszwalb_segment.restype = None
        _lib = lib
    return _lib


def _normalize_uint8(img: np.ndarray) -> np.ndarray:
    """``cv2.normalize(img, None, 0, 255, NORM_MINMAX, CV_8U)`` (reference
    code/data/superpixels.py:11), bitwise: the scale and shift in double
    from the global min and max, then cv2's conversion, which takes the
    source as f32, applies them as one f32 fused multiply-add, and rounds
    to the nearest integer, ties to even, saturating to [0, 255]."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX, cv2.CV_8U)
    img = np.asarray(img)
    lo, hi = float(img.min()), float(img.max())
    scale = 255.0 * (1.0 / (hi - lo)
                     if hi - lo > np.finfo(np.float64).eps else 0.0)
    shift = 0.0 - lo * scale
    # f32 x f32 is exact in f64, so one rounding to f32 after the add is
    # the fused multiply-add's
    x = img.astype(np.float32).astype(np.float64)
    v = (x * np.float64(np.float32(scale))
         + np.float64(np.float32(shift))).astype(np.float32)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _rgb_to_lab_f32(img_uint8: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float32 CIELAB (D65), like skimage's convert2lab:
    ``cv2.cvtColor`` where cv2 is installed, else the port's
    ``ops/slic_device.rgb_to_lab`` on the CPU."""
    f = img_uint8.astype(np.float32) / 255.0
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.cvtColor(f, cv2.COLOR_RGB2LAB)
    import torch

    from videowalk_tpu_torch.ops.slic_device import rgb_to_lab

    return rgb_to_lab(torch.from_numpy(f)).numpy()


def _gaussian_kernel(sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, CV_32F)`` at the size
    ``cv2.GaussianBlur`` picks for float images, ``round(8 sigma + 1) | 1``
    (5 taps at sigma 0.5): the taps in double, normalized, cast to f32."""
    n = int(np.floor(sigma * 8 + 1 + 0.5)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2
    t = np.exp(-0.5 * x * x / (sigma * sigma))
    return (t / t.sum()).astype(np.float32)


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of an f32 ``(H, W, C)``
    image: cv2's kernel along the rows, then along the columns, in f32, the
    symmetric taps paired as cv2 pairs them, borders ``BORDER_REFLECT_101``
    (``np.pad``'s ``reflect``)."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.GaussianBlur(img, (0, 0), sigma)
    k = _gaussian_kernel(sigma)
    r = len(k) // 2

    def along(x: np.ndarray, axis: int) -> np.ndarray:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (r, r)
        xp = np.pad(x, pad, mode="reflect")
        n = x.shape[axis]

        def tap(d):
            return np.take(xp, np.arange(r + d, r + d + n), axis=axis)

        out = k[r] * tap(0)
        for d in range(1, r + 1):
            out = out + k[r + d] * (tap(-d) + tap(d))
        return out.astype(np.float32)

    return along(along(np.asarray(img, np.float32), 1), 0)


def _slic_numpy(lab: np.ndarray, n_segments: int, compactness: float,
                n_iter: int = 10) -> np.ndarray:
    """Vectorized numpy SLIC (the ``numpy`` backend and the test oracle of
    the C++ and device paths)."""
    H, W = lab.shape[:2]
    S = np.sqrt(H * W / n_segments)
    ratio = compactness / S

    gh = max(1, int(np.sqrt(n_segments * H / W) + 0.5))
    gw = int(np.ceil(n_segments / gh))
    cy = ((np.arange(n_segments) // gw) % gh + 0.5) * H / gh
    cx = (np.arange(n_segments) % gw + 0.5) * W / gw
    ci = (np.clip(cy.astype(int), 0, H - 1) * W
          + np.clip(cx.astype(int), 0, W - 1))
    flat = lab.reshape(-1, 3)
    c_color = flat[ci].copy()

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    py, px = yy.ravel(), xx.ravel()

    labels = np.zeros(H * W, np.int32)
    for _ in range(n_iter):
        dist = np.full(H * W, np.inf, np.float32)
        for k in range(n_segments):
            y0, y1 = max(0, int(cy[k] - 2 * S)), min(H, int(cy[k] + 2 * S) + 1)
            x0, x1 = max(0, int(cx[k] - 2 * S)), min(W, int(cx[k] + 2 * S) + 1)
            win = (yy[y0:y1, x0:x1], xx[y0:y1, x0:x1])
            idx = (win[0].astype(int) * W + win[1].astype(int)).ravel()
            dc = ((flat[idx] - c_color[k]) ** 2).sum(-1)
            ds = ((win[0].ravel() - cy[k]) ** 2 + (win[1].ravel() - cx[k]) ** 2)
            d = dc + ds * ratio * ratio
            better = d < dist[idx]
            dist[idx[better]] = d[better]
            labels[idx[better]] = k
        for k in range(n_segments):
            sel = labels == k
            if sel.any():
                cy[k], cx[k] = py[sel].mean(), px[sel].mean()
                c_color[k] = flat[sel].mean(0)
    return labels.reshape(H, W)


def compute_sp_slic(img: np.ndarray, num_components: int, compactness: float,
                    enforce_connectivity: bool = True,
                    backend: str = "native") -> np.ndarray:
    """SLIC superpixels for one frame (reference
    code/data/superpixels.py:9-15).

    Args:
      img: HxWx3 array, any range (min-max normalized to uint8 like the
        reference's cv2.normalize call).
      backend: 'native' (C++; a failed build raises), 'numpy', or 'device'
        (``ops/slic_device.slic``, the plain version of the card's SLIC, on
        the CPU).
    """
    img8 = _normalize_uint8(np.ascontiguousarray(img))
    lab = np.ascontiguousarray(_rgb_to_lab_f32(img8), np.float32)
    H, W = lab.shape[:2]
    if backend == "native":
        out = np.empty((H, W), np.int32)
        _native().slic_segment(
            lab.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            H, W, int(num_components), float(compactness), 10,
            int(enforce_connectivity),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out
    if backend == "numpy":
        return _slic_numpy(lab, int(num_components), float(compactness))
    if backend == "device":
        import torch

        from videowalk_tpu_torch.ops.slic_device import slic

        x = torch.from_numpy(img8[None].astype(np.float32)) / 255.0
        return slic(x, int(num_components), float(compactness))[0].numpy()
    raise ValueError(f"unknown backend {backend!r}")


def compute_sp_FH(img: np.ndarray, scale: float = 600.0, sigma: float = 0.5,
                  min_size: int = 400) -> np.ndarray:
    """Felzenszwalb segmentation (reference code/data/superpixels.py:18-20)
    of the image blurred by ``cv2.GaussianBlur(img, (0, 0), sigma)``."""
    img = np.ascontiguousarray(img, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if sigma > 0:
        img = _gaussian_blur(img, sigma)
    lib = _native()
    H, W = img.shape[:2]
    out = np.empty((H, W), np.int32)
    img = np.ascontiguousarray(img, np.float32)
    lib.felzenszwalb_segment(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        H, W, float(scale), int(min_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def compute_mask(video: np.ndarray, sp_method: str, num_components: int,
                 p: float, randomise_superpixels: bool,
                 randomise_superpixels_range: int, compactness: float,
                 rng: np.random.RandomState | None = None) -> np.ndarray:
    """Per-frame superpixel masks for a clip (reference
    code/data/superpixels.py:23-63).

    Args:
      video: (T, C, H, W) or (T, H, W, C) float array (reference passes
        T,C,H,W tensors and permutes per frame).
    Returns:
      (T, 3, H, W) int mask: dense ids replicated to 3 channels, the
      reference's output layout (:59-62). FH ids are not bounded by the
      model's node slots: the step drops ids at or above ``max_sp_num``.
    """
    rng = rng or np.random
    if video.shape[1] == 3 and video.ndim == 4:
        video = np.moveaxis(video, 1, -1)  # -> (T, H, W, C)

    if sp_method == "random":
        method = str(np.asarray(
            rng.choice(["slic", "fh"], 1, p=[p, 1 - p]))[0])
    else:
        method = sp_method

    frames = []
    for t in range(video.shape[0]):
        img = video[t]
        if method == "slic":
            if randomise_superpixels:
                low = num_components - randomise_superpixels_range // 2
                high = num_components + randomise_superpixels_range // 2
                n = int(rng.randint(low, high))
            else:
                n = num_components
            seg = compute_sp_slic(img, n, compactness)
        elif method == "fh":
            seg = compute_sp_FH(img)
        else:
            raise ValueError(f"unknown sp_method {method!r}")
        frames.append(seg)

    mask = np.stack(frames)                      # (T, H, W)
    return np.repeat(mask[:, None], 3, axis=1)   # (T, 3, H, W)


def host_sp_mask(views: dict, dataset, rng: np.random.RandomState
                 ) -> np.ndarray:
    """A dataset item's superpixel ids ``(T, h, w)`` int32 made on the host
    from ``views["whole_unnorm"]`` with the item's own stream ``rng``
    (reference worker, code/data/kinetics.py:119-126), or an empty int32
    array where ``dataset`` makes none (``sp_method`` 'none', or
    ``sp_backend`` 'device': the trainer segments on the card). ``dataset``
    carries ``sp_method``, ``sp_backend``, ``num_components``, ``prob``,
    ``randomise_superpixels``, ``randomise_superpixels_range`` and
    ``compactness``."""
    if dataset.sp_method == "none" or dataset.sp_backend != "host":
        return np.zeros((0,), np.int32)
    mask3 = compute_mask(
        views["whole_unnorm"], dataset.sp_method, dataset.num_components,
        dataset.prob, dataset.randomise_superpixels,
        dataset.randomise_superpixels_range, dataset.compactness, rng=rng)
    return mask3[:, 0].astype(np.int32)
