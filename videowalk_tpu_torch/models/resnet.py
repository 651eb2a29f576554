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
``layer2.0.downsample.0.weight``, ...).

Reflect convs that pass ``ops/reflect_conv.py::rconv_kernel_routes`` under
the ``rconv`` mode (``auto``: the layer4 interiors at 8x8; ``on``: every 3x3
stride-1 conv on 8-32 power-of-two maps) go through ``ops/rconv.py``: the
CUDA kernels on the card, their plain versions on the CPU. ``bn_fuse``
is the JAX package's ``VIDEOWALK_BN_FUSE``:

- ``"stats"``: a routed conv in train mode emits the following BN's
  moments from its epilogue and the BN takes them (``BatchNorm(...,
  moments=)``, the JAX ``FusedStatsBN``);
- ``"auto"`` (the default): that, and the BN-input chain: in a train-mode
  ``BasicBlock`` whose ``conv2`` routes, ``bn1`` is reduced to its
  per-channel affine (``BatchNorm.fold_affine``, the JAX ``BNAffine``) and
  ``conv2`` applies ``relu(a·y1 + b)`` to conv1's raw output inside its
  kernel (``reflect_conv3x3_bnin_stats``), so bn1's normalized output is
  never written;
- ``"off"``: the unfused BN everywhere.

Eval mode takes neither fold.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from videowalk_tpu_torch.ops.rconv import (reflect_conv3x3,
                                           reflect_conv3x3_bnin_stats,
                                           reflect_conv3x3_stats)
from videowalk_tpu_torch.ops.reflect_conv import (check_rconv_mode,
                                                  rconv_kernel_routes)

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

    ``moments=(s1, s2)`` (train mode) are the f32 per-channel sums of ``x``
    and ``x²`` over N·H·W, from the conv's epilogue (the JAX package's
    ``FusedStatsBN``): mean = s1/count and var = max(0, s2/count − mean²)
    with count = N·H·W, and no reduction over ``x``.

    ``fold_affine(x, moments)`` is train-mode BN reduced to ``(a, b)``
    (the JAX package's ``BNAffine``): the same moments and
    running-statistics update, and the normalize left to the consumer as
    ``a·x + b``.

    Eval mode normalizes with the running statistics in f32."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.dtype = dtype

    def _batch_stats(self, x: torch.Tensor, xf: torch.Tensor, moments):
        """Train mode: the batch ``(mean, var)`` in f32, from ``moments`` or
        a reduce over ``xf``, and the running statistics updated."""
        if moments is None:
            mean = xf.mean(dim=(0, 2, 3))
            ex2 = (xf * xf).mean(dim=(0, 2, 3))
        else:
            count = x.numel() // x.shape[1]
            mean, ex2 = moments[0] / count, moments[1] / count
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(
                mean.detach(), alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(
                var.detach(), alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return mean, var

    def fold_affine(self, x: torch.Tensor,
               moments: tuple[torch.Tensor, torch.Tensor] | None = None):
        """Train-mode BN of ``x`` as its per-channel f32 affine ``(a, b)``:
        ``a = rsqrt(var + eps)·weight``, ``b = bias − mean·a``. Gradients
        reach weight, bias and (through the moments) ``x``."""
        xf = None if moments is not None else x.float()
        mean, var = self._batch_stats(x, xf, moments)
        a = torch.rsqrt(var + self.eps) * self.weight
        return a, self.bias - mean * a

    def forward(self, x: torch.Tensor, train: bool = False,
                moments: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not train:
            y = F.batch_norm(xf, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.dtype)
        mean, var = self._batch_stats(x, xf, moments)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


class PadConv2d(nn.Conv2d):
    """Bias-free conv with torch-style explicit padding: ``reflect`` takes
    the reflect-conv kernels where ``rconv_kernel_routes`` admits the
    geometry under ``rconv``, else pads with ``F.pad`` and convolves
    unpadded; ``zeros`` uses the conv's own zero padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 padding: int, padding_mode: str,
                 dtype: torch.dtype, rconv: str):
        if padding_mode not in ("zeros", "reflect"):
            raise ValueError(f"padding_mode {padding_mode!r}: want zeros | reflect")
        check_rconv_mode(rconv)
        self.reflect_pad = padding if padding_mode == "reflect" else 0
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=0 if self.reflect_pad else padding, bias=False)
        self.dtype = dtype
        self.rconv = rconv

    def routes(self, x: torch.Tensor) -> bool:
        """Whether this conv of ``x`` takes the reflect-conv kernels."""
        return self.reflect_pad > 0 and rconv_kernel_routes(
            x.shape[2], x.shape[3], x.shape[1], self.out_channels,
            self.rconv, kernel=self.kernel_size[0], stride=self.stride[0],
            pad=self.reflect_pad)

    def forward_stats(self, x: torch.Tensor):
        """A routed conv plus the following BN's moments ``(y, s1, s2)``."""
        return reflect_conv3x3_stats(x.to(self.dtype),
                                     self.weight.to(self.dtype))

    def forward_bnin_stats(self, x: torch.Tensor, a: torch.Tensor,
                           b: torch.Tensor):
        """A routed conv of ``relu(a·x + b)`` plus the following BN's
        moments ``(y, s1, s2)``."""
        return reflect_conv3x3_bnin_stats(x.to(self.dtype), a, b,
                                          self.weight.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.routes(x):
            return reflect_conv3x3(x, self.weight.to(self.dtype))
        if self.reflect_pad:
            p = self.reflect_pad
            x = F.pad(x, (p, p, p, p), mode="reflect")
        return self._conv_forward(x, self.weight.to(self.dtype), None)


def check_bn_fuse(bn_fuse: str) -> None:
    if bn_fuse not in ("auto", "stats", "off"):
        raise ValueError(f"bn_fuse={bn_fuse!r}: want auto | stats | off")


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut (ResNet-18 block)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, padding_mode: str,
                 dtype: torch.dtype = torch.float32, rconv: str = "auto",
                 bn_fuse: str = "auto"):
        super().__init__()
        check_bn_fuse(bn_fuse)
        self.bn_fuse = bn_fuse
        self.conv1 = PadConv2d(cin, filters, 3, stride, 1, padding_mode, dtype,
                               rconv)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = PadConv2d(filters, filters, 3, 1, 1, padding_mode, dtype,
                               rconv)
        self.bn2 = BatchNorm(filters, dtype)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.ModuleList([
                PadConv2d(cin, filters, 1, stride, 0, padding_mode, dtype,
                          "off"),
                BatchNorm(filters, dtype)])

    def _conv_moments(self, conv: PadConv2d, x: torch.Tensor, train: bool):
        """The conv's raw output and the following BN's moments: from the
        conv's epilogue where the conv routes to the kernels, BN is in
        train mode and ``bn_fuse`` is not off, else ``None`` (the BN then
        reduces its own; the JAX ``_conv_moments`` / ``_conv_bn``)."""
        if train and self.bn_fuse != "off" and conv.routes(x):
            y, s1, s2 = conv.forward_stats(x)
            return y, (s1, s2)
        return conv(x), None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y1, m1 = self._conv_moments(self.conv1, x, train)
        if train and self.bn_fuse == "auto" and self.conv2.routes(y1):
            # the BN-input chain: conv1's raw output goes straight into
            # conv2's kernel, which applies bn1's affine and the ReLU to its
            # operand and emits bn2's moments
            a, b = self.bn1.fold_affine(y1, m1)
            y, s1, s2 = self.conv2.forward_bnin_stats(y1, a, b)
            y = self.bn2(y, train, moments=(s1, s2))
        else:
            y = F.relu(self.bn1(y1, train, moments=m1))
            y, m2 = self._conv_moments(self.conv2, y, train)
            y = self.bn2(y, train, moments=m2)
        residual = x
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = bn(conv(x), train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet trunk: stem + the stages not in ``remove_layers``.

    ``stage_strides`` is the per-stage first-block stride; ``(1, 2, 1, 1)``
    is torchvision's ``(1, 2, 2, 2)`` after ``modify()``. 256x256 input ->
    32x32 map (map scale 8) with those strides. ``rconv`` and ``bn_fuse``
    route the blocks' reflect convs (module docstring).
    """

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_strides: Sequence[int] = (1, 2, 1, 1),
                 padding_mode: str = "zeros",
                 remove_layers: Sequence[str] = (),
                 dtype: torch.dtype = torch.float32, rconv: str = "auto",
                 bn_fuse: str = "auto"):
        super().__init__()
        check_rconv_mode(rconv)
        check_bn_fuse(bn_fuse)
        self.stage_strides = tuple(stage_strides)
        self.remove_layers = tuple(remove_layers)
        self.conv1 = PadConv2d(3, 64, 7, 2, 3, padding_mode, dtype, "off")
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
                                         padding_mode, dtype, rconv, bn_fuse))
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
             dtype: torch.dtype = torch.float32, rconv: str = "auto",
             bn_fuse: str = "auto") -> ResNet:
    """ResNet-18 trunk (reference ``code/resnet.py`` ctor + ``modify``)."""
    return ResNet((2, 2, 2, 2), (1, 2, 1, 1), padding_mode, remove_layers,
                  dtype, rconv, bn_fuse)
