"""ResNet-18 and ResNet-50 trunks with the reference's ``modify()``
semantics.

Counterpart of ``videowalk_tpu/models/resnet.py`` (torchvision
``BasicBlock`` and ``Bottleneck`` semantics, reference ``code/resnet.py``):

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
  normalization are f32 and cast back to ``dtype``;
- every train-mode BN runs with what follows it (the residual add, the
  ReLU, the projection's BN) as one ``ops/bn_act.py::bn_act``: the
  hand-written kernels on the card, the eager chain on the CPU.

Layout is NCHW (PyTorch's habit); module and parameter names are the
reference ``state_dict`` names (``layer1.0.conv1.weight``,
``layer2.0.downsample.0.weight``, ...).

Reflect convs that pass ``ops/reflect_conv.py::rconv_kernel_routes`` under
the ``rconv`` mode (``on``: every 3x3 stride-1 conv on 8-32 power-of-two
maps; ``auto``, the default: the H100's set, today the same) go through
``ops/rconv.py``: the CUDA kernels on the card, their plain versions on
the CPU. ``bn_fuse``
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

Eval mode takes neither fold. A ``Bottleneck`` takes the moment fold on
its 3x3 (``conv2``) and no BN-input chain, as in the JAX package.

``remat`` / ``remat_stages`` rematerialize the blocks of the listed stages
in the backward pass (``torch.utils.checkpoint``, the JAX ``nn.remat``).
The recomputed forward does not update the BN running statistics again:
they move once a step, as under JAX's recompute. Launch counters count a
recomputed kernel twice.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from videowalk_tpu_torch.ops.bn_act import bn_act, bn_affine
from videowalk_tpu_torch.ops.rconv import (reflect_conv3x3,
                                           reflect_conv3x3_bnin_stats,
                                           reflect_conv3x3_stats)
from videowalk_tpu_torch.ops.reflect_conv import (check_rconv_mode,
                                                  rconv_kernel_routes)
from videowalk_tpu_torch.utils.profile import backward_span, span

BN_EPS = 1e-5
BN_MOMENTUM = 0.1      # torch convention: new = 0.9 * running + 0.1 * batch
STAGE_WIDTHS = (64, 128, 256, 512)
ALL_STAGES = frozenset({"layer1", "layer2", "layer3", "layer4"})

# set while torch.utils.checkpoint recomputes a block's forward
_recompute = threading.local()


@contextlib.contextmanager
def _recomputing():
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = False


def _remat_contexts():
    """``checkpoint``'s ``context_fn``: nothing around the first forward,
    ``_recomputing`` around the recompute."""
    return contextlib.nullcontext(), _recomputing()


def remat_stage_set(remat_stages: str | None) -> frozenset:
    """The stages ``remat_stages`` names: ``None``, ``""`` and ``"all"`` are
    every stage, else a comma list. An unknown name raises: a typo would
    buy no memory and cost the recompute (the JAX ``_remat_stage_set``,
    whose ``VIDEOWALK_REMAT_STAGES`` knob is an argument here)."""
    if remat_stages is None or remat_stages in ("", "all"):
        return ALL_STAGES
    stages = frozenset(s.strip() for s in remat_stages.split(",") if s.strip())
    bad = stages - ALL_STAGES
    if bad:
        raise ValueError(
            f"remat_stages contains unknown stage(s) {sorted(bad)}; "
            f"valid: {sorted(ALL_STAGES)} or 'all'")
    return stages


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` parameters and buffers (the reference
    ``state_dict`` names) with flax's train-mode semantics:

    - batch moments in f32, the fast variance ``max(0, E[y^2] - E[y]^2)``
      (biased), gradients flowing through both;
    - output ``(y - mean) * (rsqrt(var + eps) * weight) + bias`` in f32,
      cast back to ``dtype`` (flax's ``_normalize`` order);
    - running statistics ``0.9 * running + 0.1 * batch`` with that *biased*
      variance (``nn.BatchNorm2d`` uses the unbiased one), updated in place,
      and not again when a rematerialized block recomputes its forward.

    ``moments=(s1, s2)`` (train mode) are the f32 per-channel sums of ``x``
    and ``x²`` over N·H·W, from the conv's epilogue (the JAX package's
    ``FusedStatsBN``): mean = s1/count and var = max(0, s2/count − mean²)
    with count = N·H·W, and no reduction over ``x``.

    ``forward`` also takes what follows the BN in a block: ``shortcut`` (the
    identity, added after the cast), ``proj = (yd, bn_d)`` (the projection's
    raw conv output and its BN, whose cast output is added) and ``relu``.
    Train mode runs the whole as ``ops/bn_act.py::bn_act``: hand-written
    kernels on the card, the eager chain on the CPU.

    ``fold_affine(x, moments)`` is train-mode BN reduced to ``(x, a, b)``
    (the JAX package's ``BNAffine``; ``ops/bn_act.py::bn_affine``): the same
    moments and running-statistics update, and the normalize left to the
    consumer as ``a·x + b``, which takes the returned ``x``.

    Eval mode normalizes with the running statistics in f32."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.dtype = dtype
        # a torch.distributed process group (parallel/mesh.py::
        # attach_group): train-mode moments over its global batch
        self.group = None

    def fold_affine(self, x: torch.Tensor,
                    moments: tuple[torch.Tensor, torch.Tensor] | None = None):
        """Train-mode BN of ``x`` as ``(x, a, b)``: the per-channel f32
        affine ``a = rsqrt(var + eps)·weight``, ``b = bias − mean·a``.
        Gradients reach weight, bias and (through the moments) ``x``."""
        return bn_affine(x, self, moments,
                         update=not getattr(_recompute, "on", False))

    def forward(self, x: torch.Tensor, train: bool = False,
                moments: tuple[torch.Tensor, torch.Tensor] | None = None, *,
                shortcut: torch.Tensor | None = None, proj=None,
                relu: bool = False) -> torch.Tensor:
        if train:
            return bn_act(x, self, moments, shortcut=shortcut, proj=proj,
                          relu=relu,
                          update=not getattr(_recompute, "on", False))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        y = F.batch_norm(xf, self.running_mean, self.running_var,
                         self.weight, self.bias, False, 0.0, self.eps)
        y = y.to(self.dtype)
        if proj is not None:
            shortcut = proj[1](proj[0], False)
        if shortcut is not None:
            y = y + shortcut
        return F.relu(y) if relu else y


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


def _conv_moments(conv: PadConv2d, x: torch.Tensor, train: bool,
                  bn_fuse: str):
    """The conv's raw output and the following BN's moments: from the
    conv's epilogue where the conv routes to the kernels, BN is in train
    mode and ``bn_fuse`` is not off, else ``None`` (the BN then reduces its
    own; the JAX ``_conv_moments`` / ``_conv_bn``)."""
    if train and bn_fuse != "off" and conv.routes(x):
        y, s1, s2 = conv.forward_stats(x)
        return y, (s1, s2)
    return conv(x), None


def _projection(cin: int, cout: int, stride: int, padding_mode: str,
                dtype: torch.dtype) -> nn.ModuleList:
    """The shortcut's 1x1 conv + BN (``downsample.0`` / ``downsample.1``)."""
    return nn.ModuleList([
        PadConv2d(cin, cout, 1, stride, 0, padding_mode, dtype, "off"),
        BatchNorm(cout, dtype)])


def _shortcut(downsample: nn.ModuleList | None, x: torch.Tensor,
              pointwise: bool = False) -> dict:
    """The block's last BN's ``shortcut=x``, or ``proj=(conv(x), bn)``
    where the block has a projection (its conv in a ``pointwise`` span
    with ``pointwise``)."""
    if downsample is None:
        return dict(shortcut=x)
    conv, bn = downsample
    return dict(proj=(_pointwise(conv, x) if pointwise else conv(x), bn))


def _pointwise(conv: PadConv2d, x: torch.Tensor) -> torch.Tensor:
    """A Bottleneck's 1x1 conv in a ``pointwise`` span, and its dx and dW
    in a ``pointwise.backward`` span. That span closes on the weight's
    gradient, not on ``x``'s: one autograd node makes both, and a block
    input that also feeds the projection gets its whole gradient only
    after the rest of the block's backward."""
    with span("pointwise"):
        y = conv(x)
    backward_span("pointwise.backward", y, conv)
    return y


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
            self.downsample = _projection(cin, filters, stride, padding_mode,
                                          dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y1, m1 = _conv_moments(self.conv1, x, train, self.bn_fuse)
        if train and self.bn_fuse == "auto" and self.conv2.routes(y1):
            # the BN-input chain: conv1's raw output goes straight into
            # conv2's kernel, which applies bn1's affine and the ReLU to its
            # operand and emits bn2's moments
            y1, a, b = self.bn1.fold_affine(y1, m1)
            y, s1, s2 = self.conv2.forward_bnin_stats(y1, a, b)
            m2 = (s1, s2)
        else:
            y = self.bn1(y1, train, moments=m1, relu=True)
            y, m2 = _conv_moments(self.conv2, y, train, self.bn_fuse)
        return self.bn2(y, train, moments=m2, relu=True,
                        **_shortcut(self.downsample, x))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (ResNet-50 block), torchvision
    semantics: the stride on the 3x3, expansion 4, a projection shortcut
    where the stride or the width changes. The 3x3 is a ``PadConv2d``
    (the reflect-conv kernels where it routes, with bn2's moments from its
    epilogue in train mode unless ``bn_fuse`` is off); the 1x1s and the
    projection are plain convs, each in a ``pointwise`` span (its
    backward in ``pointwise.backward``; ``utils/profile.py``)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, padding_mode: str,
                 dtype: torch.dtype = torch.float32, rconv: str = "auto",
                 bn_fuse: str = "auto"):
        super().__init__()
        check_bn_fuse(bn_fuse)
        self.bn_fuse = bn_fuse
        cout = filters * self.expansion
        self.conv1 = PadConv2d(cin, filters, 1, 1, 0, padding_mode, dtype,
                               "off")
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = PadConv2d(filters, filters, 3, stride, 1, padding_mode,
                               dtype, rconv)
        self.bn2 = BatchNorm(filters, dtype)
        self.conv3 = PadConv2d(filters, cout, 1, 1, 0, padding_mode, dtype,
                               "off")
        self.bn3 = BatchNorm(cout, dtype)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = _projection(cin, cout, stride, padding_mode,
                                          dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.bn1(_pointwise(self.conv1, x), train, relu=True)
        y, m2 = _conv_moments(self.conv2, y, train, self.bn_fuse)
        y = self.bn2(y, train, moments=m2, relu=True)
        return self.bn3(_pointwise(self.conv3, y), train, relu=True,
                        **_shortcut(self.downsample, x, pointwise=True))


class ResNet(nn.Module):
    """ResNet trunk: stem + the stages not in ``remove_layers``.

    ``stage_strides`` is the per-stage first-block stride; ``(1, 2, 1, 1)``
    is torchvision's ``(1, 2, 2, 2)`` after ``modify()``. 256x256 input ->
    32x32 map (map scale 8) with those strides. ``rconv`` and ``bn_fuse``
    route the blocks' reflect convs (module docstring). ``block`` is
    ``BasicBlock`` or ``Bottleneck``; ``hid_dim`` is the last kept stage's
    width times its expansion. With ``remat``, the blocks of the stages in
    ``remat_stage_set(remat_stages)`` recompute their forward in the
    backward pass.
    """

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_strides: Sequence[int] = (1, 2, 1, 1),
                 padding_mode: str = "zeros",
                 remove_layers: Sequence[str] = (),
                 dtype: torch.dtype = torch.float32, rconv: str = "auto",
                 bn_fuse: str = "auto", block: type = BasicBlock,
                 remat: bool = False, remat_stages: str | None = None):
        super().__init__()
        check_rconv_mode(rconv)
        check_bn_fuse(bn_fuse)
        self.stage_strides = tuple(stage_strides)
        self.remove_layers = tuple(remove_layers)
        self.remat_stages = remat_stage_set(remat_stages) if remat \
            else frozenset()
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
                blocks.append(block(cin, width, stride if b == 0 else 1,
                                    padding_mode, dtype, rconv, bn_fuse))
                cin = width * block.expansion
            setattr(self, name, nn.ModuleList(blocks))
            self.stages.append(name)
        self.hid_dim = cin

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, 3, H, W) -> (B, hid_dim, H/scale, W/scale) in ``dtype``."""
        x = self.bn1(self.conv1(x), train, relu=True)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.stages:
            remat = name in self.remat_stages and torch.is_grad_enabled()
            for blk in getattr(self, name):
                if remat:
                    x = checkpoint(blk, x, train, use_reentrant=False,
                                   context_fn=_remat_contexts)
                else:
                    x = blk(x, train)
        return x


def resnet18(padding_mode: str = "zeros", remove_layers: Sequence[str] = (),
             dtype: torch.dtype = torch.float32, rconv: str = "auto",
             bn_fuse: str = "auto", remat: bool = False,
             remat_stages: str | None = None) -> ResNet:
    """ResNet-18 trunk (reference ``code/resnet.py`` ctor + ``modify``)."""
    return ResNet((2, 2, 2, 2), (1, 2, 1, 1), padding_mode, remove_layers,
                  dtype, rconv, bn_fuse, BasicBlock, remat, remat_stages)


def resnet50(padding_mode: str = "zeros", remove_layers: Sequence[str] = (),
             dtype: torch.dtype = torch.float32, rconv: str = "auto",
             bn_fuse: str = "auto", remat: bool = False,
             remat_stages: str | None = None) -> ResNet:
    """ResNet-50 trunk (reference ``code/resnet.py`` ctor + ``modify``)."""
    return ResNet((3, 4, 6, 3), (1, 2, 1, 1), padding_mode, remove_layers,
                  dtype, rconv, bn_fuse, Bottleneck, remat, remat_stages)
