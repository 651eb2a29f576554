"""ResNet-18 trunk with the reference's ``modify()`` semantics.

Counterpart of ``videowalk_tpu/models/resnet.py`` (torchvision BasicBlock
semantics, reference ``code/resnet.py``):

- stride-1 layer3/4 (every conv of those stages, the 1x1 projection too);
- reflect padding is ``F.pad(mode="reflect")`` + an unpadded conv; zeros
  padding is the conv's own padding;
- ``remove_layers`` drops whole stages; there is no ``fc``/``avgpool``;
- BatchNorm with eps 1e-5 (torch defaults); the stem's 3x3/2 maxpool pads
  with -inf, as flax's ``nn.max_pool`` does;
- ``train`` is an argument of ``forward`` (the JAX package's convention),
  not the module's ``training`` flag. Train-mode BN follows flax
  (``BatchNorm`` below); eval-mode BN is ``F.batch_norm`` on the running
  statistics;
- ``dtype``: parameters stay f32, convolutions compute in ``dtype`` (x and
  w cast, as the JAX package's ``PadConv`` does), BN statistics and the
  normalization are f32 and cast back to ``dtype``.

Layout is NCHW (PyTorch's habit); module and parameter names are the
reference ``state_dict`` names (``layer1.0.conv1.weight``,
``layer2.0.downsample.0.weight``, ...). The train-mode BN fusions of the JAX
package (``FusedStatsBN``, ``BNAffine``) ride on its reflect-conv kernels,
which the port does not have yet (the JAX package's own route off every backend
but the TPU): the BN here is the unfused one.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1      # torch convention: new = 0.9 * running + 0.1 * batch
STAGE_WIDTHS = (64, 128, 256, 512)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` parameters and buffers (the reference
    ``state_dict`` names) with flax's train-mode semantics:

    - batch moments in f32, the fast variance ``max(0, E[y^2] - E[y]^2)``
      (biased), gradients flowing through both;
    - output ``(y - mean) * (rsqrt(var + eps) * weight) + bias`` in f32,
      cast back to ``dtype`` (flax's ``_normalize`` order);
    - running statistics ``0.9 * running + 0.1 * batch`` with that *biased*
      variance (``nn.BatchNorm2d`` uses the unbiased one), updated in place.

    Eval mode normalizes with the running statistics in f32."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not train:
            y = F.batch_norm(xf, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.dtype)
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(
                mean.detach(), alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(
                var.detach(), alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


class PadConv2d(nn.Conv2d):
    """Bias-free conv with torch-style explicit padding: ``reflect`` pads
    with ``F.pad`` and convolves unpadded; ``zeros`` uses the conv's own
    zero padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 padding: int, padding_mode: str,
                 dtype: torch.dtype = torch.float32):
        if padding_mode not in ("zeros", "reflect"):
            raise ValueError(f"padding_mode {padding_mode!r}: want zeros | reflect")
        self.reflect_pad = padding if padding_mode == "reflect" else 0
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=0 if self.reflect_pad else padding, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.reflect_pad:
            p = self.reflect_pad
            x = F.pad(x, (p, p, p, p), mode="reflect")
        return self._conv_forward(x, self.weight.to(self.dtype), None)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut (ResNet-18 block)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, padding_mode: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = PadConv2d(cin, filters, 3, stride, 1, padding_mode, dtype)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = PadConv2d(filters, filters, 3, 1, 1, padding_mode, dtype)
        self.bn2 = BatchNorm(filters, dtype)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.ModuleList([
                PadConv2d(cin, filters, 1, stride, 0, padding_mode, dtype),
                BatchNorm(filters, dtype)])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = x
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = bn(conv(x), train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet trunk: stem + the stages not in ``remove_layers``.

    ``stage_strides`` is the per-stage first-block stride; ``(1, 2, 1, 1)``
    is torchvision's ``(1, 2, 2, 2)`` after ``modify()``. 256x256 input ->
    32x32 map (map scale 8) with those strides.
    """

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_strides: Sequence[int] = (1, 2, 1, 1),
                 padding_mode: str = "zeros",
                 remove_layers: Sequence[str] = (),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stage_strides = tuple(stage_strides)
        self.remove_layers = tuple(remove_layers)
        self.conv1 = PadConv2d(3, 64, 7, 2, 3, padding_mode, dtype)
        self.bn1 = BatchNorm(64, dtype)
        cin = 64
        self.stages = []
        for s, (width, n_blocks, stride) in enumerate(
                zip(STAGE_WIDTHS, stage_sizes, stage_strides)):
            name = f"layer{s + 1}"
            if name in self.remove_layers:
                continue
            blocks = []
            for b in range(n_blocks):
                blocks.append(BasicBlock(cin, width, stride if b == 0 else 1,
                                         padding_mode, dtype))
                cin = width
            setattr(self, name, nn.ModuleList(blocks))
            self.stages.append(name)
        self.hid_dim = cin

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, 3, H, W) -> (B, hid_dim, H/scale, W/scale) in ``dtype``."""
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.stages:
            for block in getattr(self, name):
                x = block(x, train)
        return x


def resnet18(padding_mode: str = "zeros", remove_layers: Sequence[str] = (),
             dtype: torch.dtype = torch.float32) -> ResNet:
    """ResNet-18 trunk (reference ``code/resnet.py`` ctor + ``modify``)."""
    return ResNet((2, 2, 2, 2), (1, 2, 1, 1), padding_mode, remove_layers,
                  dtype)
