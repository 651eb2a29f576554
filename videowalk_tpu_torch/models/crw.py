"""CRW: Contrastive Random Walk model, patch-grid and whole-frame nodes
(counterpart of ``videowalk_tpu/models/crw.py``; reference
``code/model.py``).

``forward(x, just_feats=False, train=True)`` returns ``(q, loss, diags)``
like the JAX ``__call__``, or ``(q, maps)`` with ``just_feats``:

- patches ``(B, T, N, h, w, 3)``: ``pixels_to_nodes`` folds ``B * N`` into
  the encoder batch, means each map spatially, projects with the head (f32,
  also on a bf16 trunk) and L2-normalizes, giving ``q (B, C, T, N)``;
- whole frames ``(B, T, h, w, 3)``: one node per feature cell (the
  evaluator's path).

The trunk's reflect convs take the reflect-conv kernels where ``rconv``
routes them (``models/resnet.py``). The walk loss takes the fused kernel
(``ops/walk.py``) where the config allows (ZeroSoftmax, no flip, no zeroed
diagonal, T <= 10, N <= 128, C <= 512): on a CUDA tensor the CUDA
kernels, on a CPU tensor their plain version. Elsewhere it takes ``core/walk.py``. Random numbers (edge dropout,
featdrop) come from the ``generator`` argument. The superpixel path is
still queued (ROADMAP.md, Queue 1 item 4). ``state_dict`` names are the
reference's (``encoder.model.layer1.0.conv1.weight``, ``selfsim_fc.0.weight``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from videowalk_tpu_torch.core import walk as walk_lib
from videowalk_tpu_torch.core.walk import l2_normalize
from videowalk_tpu_torch.models.encoder import make_encoder
from videowalk_tpu_torch.ops import walk as walk_ops


@dataclasses.dataclass(frozen=True)
class CRWConfig:
    """The JAX package's ``CRWConfig`` fields that the port runs so far."""

    model_type: str = "scratch"
    remove_layers: tuple = ()
    head_depth: int = 0
    temperature: float = 0.07        # --temp
    edgedrop_rate: float = 0.0       # --dropout
    featdrop_rate: float = 0.0       # --featdrop
    flip: bool = False               # --flip
    sk_targets: bool = False         # --sk-targets: not ported yet
    zero_diagonal: bool = False      # --zero-diagonal
    head_bias: bool = False          # CRW: Linear(bias=False); TS variant: True
    use_zero_softmax: bool = True    # CRW ZeroSoftmax; TS plain softmax
    dtype: torch.dtype = torch.float32   # encoder trunk compute type
    # fused walk kernels (ops/walk.py): 'auto' takes them where the config
    # allows; 'on' forces them and raises where they do not apply; 'off'
    fused_walk: str = "auto"
    # reflect-conv kernels (ops/rconv.py): 'auto' routes the JAX package's
    # shape set (the 8x8 interiors with C >= 512), 'on' every supported
    # shape, 'off' none (ops/reflect_conv.py::rconv_kernel_routes)
    rconv: str = "auto"
    # BN fused into routed convs: 'stats' takes the moments from the conv's
    # epilogue, 'off' reduces them apart; 'auto' (the BN-input chain) raises
    bn_fuse: str = "stats"


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


class CRW(nn.Module):
    def __init__(self, cfg: CRWConfig):
        super().__init__()
        if cfg.sk_targets:
            walk_lib.sk_targets_walk_loss()          # raises: not ported yet
        if cfg.fused_walk not in ("auto", "on", "off"):
            raise ValueError(f"fused_walk={cfg.fused_walk!r}: want auto | on | off")
        self.cfg = cfg
        self.spec = make_encoder(cfg.model_type, cfg.remove_layers, cfg.dtype,
                                 cfg.rconv, cfg.bn_fuse)
        self.encoder = self.spec.module
        self.selfsim_fc = Head(self.spec.hid_dim, cfg.head_depth,
                               bias=cfg.head_bias)

    def _featdrop(self, maps, train, generator):
        rate = self.cfg.featdrop_rate
        if not train or rate <= 0:
            return maps
        if generator is None:
            raise ValueError("featdrop needs a torch.Generator")
        keep = torch.rand(maps.shape, generator=generator,
                          device=maps.device) < 1.0 - rate
        return torch.where(keep, maps / (1.0 - rate), torch.zeros_like(maps))

    def _project(self, feats):
        """Head (f32) + L2 norm over channels (reference code/model.py:117-118)."""
        feats = feats.to(torch.promote_types(feats.dtype, torch.float32))
        return l2_normalize(self.selfsim_fc(feats), dim=-1)

    def pixels_to_nodes(self, x, train: bool, generator=None):
        """``(B, T, N, h, w, 3)`` patches -> q ``(B, C, T, N)``, maps
        ``(B, T, N, H, W, C)``. Reference code/model.py:92-123."""
        B, T, N = x.shape[:3]
        xx = x.transpose(1, 2).reshape(B * N, T, *x.shape[3:])
        maps = self.encoder(xx, train)                  # (B*N, T, H, W, C)
        maps = self._featdrop(maps, train, generator)
        feats = maps.mean(dim=(2, 3), dtype=torch.promote_types(
            maps.dtype, torch.float32)).to(maps.dtype)
        feats = self._project(feats)                    # (B*N, T, C')
        q = feats.reshape(B, N, T, -1).permute(0, 3, 2, 1)
        maps = maps.reshape(B, N, T, *maps.shape[2:]).transpose(1, 2)
        return q, maps

    def whole_image_to_nodes(self, x, train: bool, generator=None):
        """``(B, T, h, w, 3)`` frames -> q ``(B, C', T, HW)`` projected +
        L2-normalized nodes, maps ``(B, T, H, W, C)``."""
        maps = self.encoder(x, train)
        maps = self._featdrop(maps, train, generator)
        B, T, H, W, C = maps.shape
        q = self._project(maps.reshape(B, T, H * W, C))
        return q.permute(0, 3, 1, 2), maps

    def forward(self, x: torch.Tensor, just_feats: bool = False,
                train: bool = True, generator: torch.Generator | None = None,
                walk_masks=None):
        """``(q, loss, diags)``, or ``(q, maps)`` with ``just_feats``.

        ``train`` puts BN in train mode (running statistics updated in
        place) and turns on edge dropout and featdrop, drawn from
        ``generator``; ``walk_masks`` ``(m12, m21)``, ``(B, T-1, N, N)``,
        replace the drawn edge-dropout masks (tests inject them)."""
        if x.dim() == 6:
            q, maps = self.pixels_to_nodes(x, train, generator)
        else:
            q, maps = self.whole_image_to_nodes(x, train, generator)
        if just_feats:
            return q, maps

        cfg = self.cfg
        _, C, T, N = q.shape
        fused_ok = (not cfg.flip and not cfg.zero_diagonal
                    and cfg.use_zero_softmax
                    and (T < 3 or walk_ops.walk_supported(T, N, C)))
        if cfg.fused_walk == "on" and not fused_ok:
            raise ValueError(
                "fused_walk='on' is incompatible with this config "
                "(flip/zero_diagonal/plain-softmax, N > 128 nodes, "
                f"clip_len > 10 or C > 512; N={N}, T={T}, C={C}); use "
                "fused_walk='auto' to let it fall back")
        rate = cfg.edgedrop_rate if train else 0.0
        masks = walk_masks if train else None
        if fused_ok and cfg.fused_walk != "off":
            loss, diags = walk_ops.fused_walk_loss(
                q, cfg.temperature, generator=generator, edgedrop_rate=rate,
                masks=masks)
        else:
            loss, diags = walk_lib.crw_walk_loss(
                q, cfg.temperature, generator=generator, edgedrop_rate=rate,
                masks=masks, flip=cfg.flip,
                use_zero_softmax=cfg.use_zero_softmax,
                zero_diagonal=cfg.zero_diagonal)
        return q, loss, diags
