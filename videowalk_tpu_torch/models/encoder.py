"""Encoder factory: model-type registry + 2D->3D time folding.

Counterpart of ``videowalk_tpu/models/encoder.py``. Video tensors at the
public boundary keep the JAX package's layout, ``(B, T, H, W, C)``;
``From3D`` folds T into the batch and runs the NCHW trunk.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from videowalk_tpu_torch.models.resnet import ResNet, resnet18

# model types whose port is still queued (ROADMAP.md, Queue 1 "Still to
# port": item 2, ResNet-50 trunks; item 7, pretrained imports)
_QUEUED_TYPES = ("scratch50", "imagenet18", "imagenet50", "moco50",
                 "timecycle", "uvc")


class From3D(nn.Module):
    """Use a 2D convnet as a 3D convnet by folding time into batch:
    ``(B, T, H, W, 3)`` -> ``(B, T, H', W', C)``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        B, T = x.shape[:2]
        m = self.model(x.reshape(B * T, *x.shape[2:]).permute(0, 3, 1, 2),
                       train)
        return m.permute(0, 2, 3, 1).reshape(B, T, *m.shape[2:], m.shape[1])


@dataclasses.dataclass
class EncoderSpec:
    """An encoder module plus its statically known output geometry."""

    module: From3D
    hid_dim: int
    map_scale: int  # input px per output feature px


def map_scale(trunk: ResNet) -> int:
    """Total spatial downscale: stem(2) * maxpool(2) * kept stage strides."""
    scale = 4
    for i, s in enumerate(trunk.stage_strides):
        if f"layer{i + 1}" not in trunk.remove_layers:
            scale *= s
    return scale


def make_encoder(model_type: str = "scratch",
                 remove_layers: Sequence[str] = (),
                 dtype: torch.dtype = torch.float32, rconv: str = "auto",
                 bn_fuse: str = "auto") -> EncoderSpec:
    """``scratch``: ResNet-18, reflect padding, stride-1 layer3/4;
    ``scratch_zeropad``: the same with zeros padding. ``dtype`` is the
    trunk's compute type (parameters stay f32); ``rconv`` and ``bn_fuse``
    route its reflect convs (``models/resnet.py``). Rematerialization
    (``remat_stages``) is still queued (ROADMAP.md, Queue 1 item 2)."""
    if model_type == "scratch":
        trunk = resnet18("reflect", tuple(remove_layers), dtype, rconv,
                         bn_fuse)
    elif model_type == "scratch_zeropad":
        trunk = resnet18("zeros", tuple(remove_layers), dtype, rconv, bn_fuse)
    elif model_type in _QUEUED_TYPES:
        raise NotImplementedError(
            f"model type {model_type!r} is not ported yet (ROADMAP.md, "
            f"Queue 1 item 2: ResNet-50 trunks; item 7: pretrained imports)")
    else:
        raise ValueError(f"invalid model_type: {model_type!r}")
    return EncoderSpec(module=From3D(trunk), hid_dim=trunk.hid_dim,
                       map_scale=map_scale(trunk))
