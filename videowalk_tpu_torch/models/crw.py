"""CRW: Contrastive Random Walk model, patch-grid, superpixel and
whole-frame nodes (counterpart of ``videowalk_tpu/models/crw.py``; reference
``code/model.py``).

``forward(x, sp_mask=None, just_feats=False, train=True)`` returns
``(q, loss, diags)`` like the JAX ``__call__``, or ``(q, maps)`` with
``just_feats``:

- patches ``(B, T, N, h, w, 3)``: ``pixels_to_nodes`` folds ``B * N`` into
  the encoder batch, means each map spatially, projects with the head (f32,
  also on a bf16 trunk) and L2-normalizes, giving ``q (B, C, T, N)``;
- whole frames ``(B, T, h, w, 3)`` with superpixel ids ``sp_mask
  (B, T, h, w)``: ``image_to_nodes`` pools the maps by segment-weighted
  sums, one node per superpixel slot. The slot count ``max_sp_num`` is
  fixed; an absent slot's pooled features are exactly zero, stay zero
  through the head and ``l2_normalize`` (with a zero gradient) and are
  unreachable under ZeroSoftmax. With ``dilate_superpixels`` the one-hot
  masks are dilated first (L1 of radius >= 2 by ``ops/dilation.py``);
- whole frames alone: one node per feature cell (the evaluator's path).

The trunk's reflect convs take the reflect-conv kernels where ``rconv``
routes them (``models/resnet.py``). With ``sk_targets`` the loss is
``core/walk.py::sk_targets_walk_loss``. Otherwise the walk loss takes the
fused kernel (``ops/walk.py``) where the config allows (ZeroSoftmax, no
flip, no zeroed diagonal, T <= 10, N <= 128, C <= 512): on a CUDA tensor
the CUDA kernels, on a CPU tensor their plain version. Elsewhere it takes
``core/walk.py``. Random numbers (edge dropout,
featdrop) come from the ``generator`` argument. ``state_dict`` names are the
reference's (``encoder.model.layer1.0.conv1.weight``, ``selfsim_fc.0.weight``).

Spans (``utils/profile.py``, on only while traced): the encoder call in
``trunk``; featdrop, the pooling (``sp_pool`` around the superpixel
weights), the head and the L2 norm in ``nodes``; the loss in ``walk``; and
the backward of each in ``trunk.backward``, ``nodes.backward`` and
``walk.backward``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from videowalk_tpu_torch.core import rng
from videowalk_tpu_torch.core import walk as walk_lib
from videowalk_tpu_torch.core.masks import make_dilation_kernel
from videowalk_tpu_torch.core.walk import l2_normalize
from videowalk_tpu_torch.models.encoder import make_encoder
from videowalk_tpu_torch.ops import walk as walk_ops
from videowalk_tpu_torch.ops.dilation import dilate_l1, unit_diamond
from videowalk_tpu_torch.utils.device import full_f32_matmul
from videowalk_tpu_torch.utils.profile import backward_span, span, spanned


@dataclasses.dataclass(frozen=True)
class CRWConfig:
    """The JAX package's ``CRWConfig`` fields that the port runs so far,
    with its defaults."""

    model_type: str = "scratch"
    remove_layers: tuple = ()
    head_depth: int = 0
    temperature: float = 0.07        # --temp
    edgedrop_rate: float = 0.0       # --dropout
    featdrop_rate: float = 0.0       # --featdrop
    flip: bool = False               # --flip
    sk_targets: bool = False         # --sk-targets
    zero_diagonal: bool = False      # --zero-diagonal
    head_bias: bool = False          # CRW: Linear(bias=False); TS variant: True
    use_zero_softmax: bool = True    # CRW ZeroSoftmax; TS plain softmax
    # Superpixels
    max_sp_num: int = 48             # fixed node-slot count (see module doc)
    dilate_superpixels: bool = False
    dilation_kernel_shape: str = "L1"   # L1 | cross | circle
    dilation_kernel_size: int = 51
    dtype: torch.dtype = torch.float32   # encoder trunk compute type
    # fused walk kernels (ops/walk.py): 'auto' takes them where the config
    # allows (on the card they beat the core walk at every swept shape:
    # ops/walk.py); 'on' forces them and raises where they do not apply;
    # 'off' never
    fused_walk: str = "auto"
    # reflect-conv kernels (ops/rconv.py): 'auto' routes the shapes the
    # H100 chose (today every supported shape: 3x3 stride-1 convs on 8-32
    # power-of-two maps), 'on' every supported shape, 'off' none
    # (ops/reflect_conv.py::rconv_kernel_routes)
    rconv: str = "auto"
    # BN fused into routed convs (train mode): 'stats' takes the moments
    # from the conv's epilogue; 'auto' also folds bn1's affine and ReLU into
    # a routed conv2's operand (the BN-input chain); 'off' does neither
    bn_fuse: str = "auto"
    # rematerialize the trunk's blocks in the backward pass: the stages of
    # remat_stages (a comma list; None, "" or "all": every stage)
    remat: bool = False
    remat_stages: str | None = None


def fused_walk_route(cfg: CRWConfig, T: int, N: int, C: int) -> bool:
    """True iff the walk loss of a ``(B, C, T, N)`` q takes the fused
    kernels (``ops/walk.py``): the config must allow them (ZeroSoftmax, no
    flip, no sk_targets, no zeroed diagonal, a supported shape); ``on``
    then forces them and ``auto`` takes them, ``off`` never."""
    fused_ok = (not cfg.flip and not cfg.sk_targets and not cfg.zero_diagonal
                and cfg.use_zero_softmax
                and (T < 3 or walk_ops.walk_supported(T, N, C)))
    if cfg.fused_walk == "on" and not fused_ok:
        raise ValueError(
            "fused_walk='on' is incompatible with this config "
            "(flip/sk_targets/zero_diagonal/plain-softmax, N > 128 nodes, "
            f"clip_len > 10 or C > 512; N={N}, T={T}, C={C}); use "
            "fused_walk='auto' to let it fall back")
    return fused_ok and cfg.fused_walk != "off"


class Head(nn.Sequential):
    """``selfsim_fc`` projection head: depth -1 -> identity; depth d ->
    (d+1) Linears with ReLU between (Sequential indices 0, 2, 4, ...)."""

    def __init__(self, in_dim: int, depth: int = 0, out_dim: int = 128,
                 bias: bool = False):
        layers = []
        if depth >= 0:
            dims = [in_dim] * (depth + 1) + [out_dim]
            for i, (d1, d2) in enumerate(zip(dims[:-1], dims[1:])):
                layers.append(nn.Linear(d1, d2, bias=bias))
                if i < len(dims) - 2:
                    layers.append(nn.ReLU())
        super().__init__(*layers)


def dilate_onehot(onehot: torch.Tensor, kernel_size: int,
                  shape: str) -> torch.Tensor:
    """Morphological dilation of 0/1 masks ``(..., h, w)`` by the odd
    structuring element ``shape`` ('L1' | 'cross' | 'circle') of radius
    ``kernel_size // 2``; same shape and type out. No gradient (the
    reference thresholds a grouped conv with ``> 0``,
    ``code/model.py:303-309``).

    L1 with radius >= 2 goes to ``ops.dilation.dilate_l1`` (its CUDA kernel
    for a CUDA tensor, its plain version on the CPU); radius 1 is one unit
    diamond; a cross is the max of two 1-D max-filters; a circle is a conv
    with the binary kernel and a ``> 0`` threshold, like the reference."""
    if shape not in ("L1", "cross", "circle"):
        raise ValueError(f"unknown dilation kernel shape: {shape!r}")
    r = kernel_size // 2
    lead, (h, w) = onehot.shape[:-2], onehot.shape[-2:]
    x = onehot.detach().reshape(-1, h, w)
    if r == 0:
        return x.reshape(*lead, h, w)
    if shape == "L1":
        x = dilate_l1(x, kernel_size) if r >= 2 else unit_diamond(x)
    elif shape == "cross":
        x = x[:, None]                  # max_pool pads with -inf: masks >= 0
        x = torch.maximum(F.max_pool2d(x, (1, 2 * r + 1), 1, (0, r)),
                          F.max_pool2d(x, (2 * r + 1, 1), 1, (r, 0)))
    else:
        kernel = make_dilation_kernel(2 * r + 1, "circle").to(x)
        x = (F.conv2d(x[:, None], kernel[None, None], padding=r) > 0).to(x)
    return x.reshape(*lead, h, w)


@spanned("sp_pool")
def superpixel_pool_weights(
    sp_mask: torch.Tensor, max_sp_num: int, feat_hw: tuple[int, int], *,
    dilate: bool = False, dilation_kernel_size: int = 51,
    dilation_kernel_shape: str = "L1",
) -> torch.Tensor:
    """Per-feature-cell, size-normalized superpixel pooling weights.

    ``sp_mask (B, T, h, w)`` integer ids in ``[0, max_sp_num)`` and the
    feature map's ``(H, W)`` (windows are ``(h // H, w // W)`` pixels) ->
    ``(B, T, H, W, SP)`` f32: column s sums to 1 over (H, W) for a present
    superpixel and is all zero for an absent one. Counts are exact integers
    in f32 on both routes. Reference ``code/model.py:296-320``."""
    B, T, h, w = sp_mask.shape
    H, W = feat_hw
    wh, ww = h // H, w // W
    if H * wh != h or W * ww != w:
        raise ValueError(f"superpixel ids {h}x{w} do not tile the {H}x{W} "
                         f"feature map")
    slots = torch.arange(max_sp_num, device=sp_mask.device)
    if dilate:
        # one-hot at pixel resolution (dilated masks overlap), bf16 through
        # the morphology (exactly 0/1); the window sums accumulate in f32
        onehot = (sp_mask[:, :, None] == slots[:, None, None]).to(
            torch.bfloat16)
        onehot = dilate_onehot(onehot, dilation_kernel_size,
                               dilation_kernel_shape)
        counts = onehot.reshape(B, T, max_sp_num, H, wh, W, ww).sum(
            (4, 6), dtype=torch.float32).movedim(2, -1)
    else:
        # histogram per window, without the pixel-level one-hot
        ids = sp_mask.reshape(B, T, H, wh, W, ww).movedim(3, 4).reshape(
            B, T, H, W, wh * ww)
        counts = (ids[..., None] == slots).sum(-2, dtype=torch.float32)
    sp_size = counts.sum(dim=(2, 3), keepdim=True)          # (B, T, 1, 1, SP)
    return counts / (sp_size + walk_lib.EPS)


class _SegmentPool(torch.autograd.Function):
    """``einsum('bthws,bthwc->btsc')`` of the (constant) pooling weights and
    the maps, the product and its transpose in the backward both in full
    f32 whatever the caller's TF32 switch."""

    @staticmethod
    def forward(ctx, weights, maps):
        ctx.save_for_backward(weights)
        with full_f32_matmul():
            return torch.einsum("bthws,bthwc->btsc", weights, maps)

    @staticmethod
    def backward(ctx, grad):
        (weights,) = ctx.saved_tensors
        with full_f32_matmul():
            return None, torch.einsum("bthws,btsc->bthwc", weights, grad)


class CRW(nn.Module):
    def __init__(self, cfg: CRWConfig):
        super().__init__()
        if cfg.fused_walk not in ("auto", "on", "off"):
            raise ValueError(f"fused_walk={cfg.fused_walk!r}: want auto | on | off")
        self.cfg = cfg
        self.spec = make_encoder(cfg.model_type, cfg.remove_layers, cfg.dtype,
                                 cfg.rconv, cfg.bn_fuse, cfg.remat,
                                 cfg.remat_stages)
        self.encoder = self.spec.module
        self.selfsim_fc = Head(self.spec.hid_dim, cfg.head_depth,
                               bias=cfg.head_bias)
        # a torch.distributed process group (parallel/mesh.py::
        # attach_group): sk_targets' Sinkhorn stops on its global batch
        self.group = None

    def _featdrop(self, maps, train, generator):
        rate = self.cfg.featdrop_rate
        if not train or rate <= 0:
            return maps
        if generator is None:
            raise ValueError("featdrop needs a torch.Generator")
        keep = rng.rand(maps.shape, generator, maps.device) < 1.0 - rate
        return torch.where(keep, maps / (1.0 - rate), torch.zeros_like(maps))

    def _project(self, feats):
        """Head (f32) + L2 norm over channels (reference code/model.py:117-118)."""
        feats = feats.to(torch.promote_types(feats.dtype, torch.float32))
        return l2_normalize(self.selfsim_fc(feats), dim=-1)

    def _trunk(self, x, train: bool):
        """The encoder's maps of ``x``, in the ``trunk`` span (its backward
        in ``trunk.backward``)."""
        with span("trunk"):
            maps = self.encoder(x, train)
        backward_span("trunk.backward", maps, x, self.encoder)
        return maps

    def pixels_to_nodes(self, x, train: bool, generator=None):
        """``(B, T, N, h, w, 3)`` patches -> q ``(B, C, T, N)``, maps
        ``(B, T, N, H, W, C)``. Reference code/model.py:92-123."""
        B, T, N = x.shape[:3]
        xx = x.transpose(1, 2).reshape(B * N, T, *x.shape[3:])
        trunk = self._trunk(xx, train)                  # (B*N, T, H, W, C)
        with span("nodes"):
            maps = self._featdrop(trunk, train, generator)
            feats = maps.mean(dim=(2, 3), dtype=torch.promote_types(
                maps.dtype, torch.float32)).to(maps.dtype)
            feats = self._project(feats)                # (B*N, T, C')
            q = feats.reshape(B, N, T, -1).permute(0, 3, 2, 1)
        backward_span("nodes.backward", q, trunk, self.selfsim_fc)
        maps = maps.reshape(B, N, T, *maps.shape[2:]).transpose(1, 2)
        return q, maps

    def whole_image_to_nodes(self, x, train: bool, generator=None):
        """``(B, T, h, w, 3)`` frames -> q ``(B, C', T, HW)`` projected +
        L2-normalized nodes, maps ``(B, T, H, W, C)``."""
        trunk = self._trunk(x, train)
        with span("nodes"):
            maps = self._featdrop(trunk, train, generator)
            B, T, H, W, C = maps.shape
            q = self._project(maps.reshape(B, T, H * W, C)).permute(0, 3, 1, 2)
        backward_span("nodes.backward", q, trunk, self.selfsim_fc)
        return q, maps

    def image_to_nodes(self, x, sp_mask, train: bool, generator=None):
        """``(B, T, h, w, 3)`` frames + ``(B, T, h, w)`` int32 or int64
        superpixel ids -> q ``(B, C', T, SP)``, maps ``(B, T, H, W, C)``.
        The pooling is an f32 product on f32-cast maps, in full f32 whatever
        the caller's TF32 switch. Reference code/model.py:260-332."""
        if (sp_mask.dtype not in (torch.int32, torch.int64)
                or sp_mask.shape != x.shape[:4] or sp_mask.device != x.device):
            raise ValueError(
                f"sp_mask must be int32 or int64 ids {tuple(x.shape[:4])} on "
                f"{x.device}; got {sp_mask.dtype} {tuple(sp_mask.shape)} on "
                f"{sp_mask.device}")
        trunk = self._trunk(x, train)                   # (B, T, H, W, C)
        cfg = self.cfg
        with span("nodes"):
            maps = self._featdrop(trunk, train, generator)
            # called through the module's global, so that a wrapper set
            # there sees each call
            weights = superpixel_pool_weights(
                sp_mask, cfg.max_sp_num, maps.shape[2:4],
                dilate=cfg.dilate_superpixels,
                dilation_kernel_size=cfg.dilation_kernel_size,
                dilation_kernel_shape=cfg.dilation_kernel_shape)
            wide = torch.promote_types(maps.dtype, torch.float32)
            sp_feats = _SegmentPool.apply(weights.to(wide), maps.to(wide))
            q = self._project(sp_feats).permute(0, 3, 1, 2)  # (B, C', T, SP)
        backward_span("nodes.backward", q, trunk, self.selfsim_fc)
        return q, maps

    def forward(self, x: torch.Tensor, sp_mask: torch.Tensor | None = None,
                just_feats: bool = False, train: bool = True,
                generator: torch.Generator | None = None, walk_masks=None):
        """``(q, loss, diags)``, or ``(q, maps)`` with ``just_feats``.

        ``train`` puts BN in train mode (running statistics updated in
        place) and turns on edge dropout and featdrop, drawn from
        ``generator``; ``walk_masks`` ``(m12, m21)``, ``(B, T-1, N, N)``,
        replace the drawn edge-dropout masks (tests inject them)."""
        if sp_mask is not None:
            q, maps = self.image_to_nodes(x, sp_mask, train, generator)
        elif x.dim() == 6:
            q, maps = self.pixels_to_nodes(x, train, generator)
        else:
            q, maps = self.whole_image_to_nodes(x, train, generator)
        if just_feats:
            return q, maps

        cfg = self.cfg
        _, C, T, N = q.shape
        rate = cfg.edgedrop_rate if train else 0.0
        masks = walk_masks if train else None
        use_fused = fused_walk_route(cfg, T, N, C)     # 'on' may raise
        with span("walk"):
            if cfg.sk_targets:
                loss, diags = walk_lib.sk_targets_walk_loss(
                    q, cfg.temperature, generator=generator,
                    edgedrop_rate=rate, masks=masks,
                    use_zero_softmax=cfg.use_zero_softmax,
                    group=self.group if train else None)
            elif use_fused:
                loss, diags = walk_ops.fused_walk_loss(
                    q, cfg.temperature, generator=generator,
                    edgedrop_rate=rate, masks=masks)
            else:
                loss, diags = walk_lib.crw_walk_loss(
                    q, cfg.temperature, generator=generator,
                    edgedrop_rate=rate, masks=masks, flip=cfg.flip,
                    use_zero_softmax=cfg.use_zero_softmax,
                    zero_diagonal=cfg.zero_diagonal)
        backward_span("walk.backward", loss, q)
        return q, loss, diags
