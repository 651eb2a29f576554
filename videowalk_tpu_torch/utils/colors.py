"""Shared color packing for the palette/label fast paths.

RGB uint8 triples are packed into one uint32 (channel 0 most significant),
so packed order == lexicographic row order and ``np.unique`` on packed
values reproduces row-wise ``np.unique(..., axis=0)`` ordering exactly.
"""

from __future__ import annotations

import numpy as np


def pack_rgb(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 -> (...) uint32, channel 0 most significant."""
    r = rgb.astype(np.uint32)
    return r[..., 0] << 16 | r[..., 1] << 8 | r[..., 2]


# matplotlib's ``cm.Paired``: its 12 RGB colors in [0, 1], so label sets need
# no matplotlib
PAIRED = np.array([
    (0.6509803921568628, 0.807843137254902, 0.8901960784313725),
    (0.12156862745098039, 0.47058823529411764, 0.7058823529411765),
    (0.6980392156862745, 0.8745098039215686, 0.5411764705882353),
    (0.2, 0.6274509803921569, 0.17254901960784313),
    (0.984313725490196, 0.6039215686274509, 0.6),
    (0.8901960784313725, 0.10196078431372549, 0.10980392156862745),
    (0.9921568627450981, 0.7490196078431373, 0.43529411764705883),
    (1.0, 0.4980392156862745, 0.0),
    (0.792156862745098, 0.6980392156862745, 0.8392156862745098),
    (0.41568627450980394, 0.23921568627450981, 0.6039215686274509),
    (1.0, 1.0, 0.6),
    (0.6941176470588235, 0.34901960784313724, 0.1568627450980392)])
