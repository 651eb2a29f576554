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

from videowalk_tpu_torch.models.resnet import ResNet, resnet18, resnet50

# model type -> (trunk, padding); the pretrained types take their weights
# from a local checkpoint afterwards (utils/pretrained.py)
_TRUNKS = {
    "scratch": (resnet18, "reflect"),
    "scratch_zeropad": (resnet18, "zeros"),
    "scratch50": (resnet50, "reflect"),
    "imagenet18": (resnet18, "zeros"),
    "imagenet50": (resnet50, "zeros"),
    "moco50": (resnet50, "zeros"),
    "timecycle": (resnet50, "zeros"),
    "uvc": (resnet18, "zeros"),
}


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
                 bn_fuse: str = "auto", remat: bool = False,
                 remat_stages: str | None = None) -> EncoderSpec:
    """An encoder by the reference's model-type name (reference
    ``code/utils/__init__.py:300-351``): ``scratch`` ResNet-18 with reflect
    padding, ``scratch_zeropad`` the same with zeros, ``scratch50``
    ResNet-50 with reflect padding; ``imagenet18`` and ``uvc`` ResNet-18,
    ``imagenet50``, ``moco50`` and ``timecycle`` ResNet-50, all with zeros
    padding, whose weights ``utils/pretrained.py`` imports from a local
    file. Every trunk has stride-1 layer3/4. ``dtype`` is the trunk's
    compute type (parameters stay f32); ``rconv`` and ``bn_fuse`` route its
    reflect convs, ``remat`` / ``remat_stages`` rematerialize its stages
    (``models/resnet.py``)."""
    if model_type not in _TRUNKS:
        raise ValueError(f"invalid model_type: {model_type!r}")
    build, padding = _TRUNKS[model_type]
    trunk = build(padding, tuple(remove_layers), dtype, rconv, bn_fuse,
                  remat, remat_stages)
    return EncoderSpec(module=From3D(trunk), hid_dim=trunk.hid_dim,
                       map_scale=map_scale(trunk))
