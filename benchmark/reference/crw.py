"""Plain f32 contrastive random walk: the ResNet trunk, the head, patch and
superpixel nodes, the palindrome walk loss, and the first Adam steps.

Weights come as a ``{state_dict name: tensor}`` dict in the reference
code's names (``encoder.model.layer1.0.conv1.weight``,
``selfsim_fc.0.weight``); a block's shortcut projection is there where
its ``downsample.0.weight`` is, and a block is a Bottleneck where its
``conv3.weight`` is (else a BasicBlock).

The trunk is the modified ResNet (Jabri et al., ``code/resnet.py``):
stride-1 layer3 and layer4, no fc, reflect padding (``F.pad`` then an
unpadded conv). Train-mode BN takes the batch moments with the biased
variance ``E[x^2] - E[x]^2`` (clamped at 0), eval-mode BN the running
statistics, eps 1e-5. Inside ``global_batch(group)`` the batch is the
global one whose equal row blocks the ranks of a ``torch.distributed``
group hold: train-mode BN's moments and the first Adam steps' losses and
gradients are then the global batch's, by all-reduces over the group.

``precision``: ``"f32"`` (TF32 off: the reference), ``"tf32"`` (TF32 on
for matmuls and cuDNN) or ``"fp8"`` (each conv's input and weight rounded
to float8 e4m3 with a per-tensor scale, then f32): the controls one step
below the precision a configuration states.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
EPS = 1e-20           # the walk's log epsilon (code/model.py:12)
ZSM_EPS = 1e-5        # ZeroSoftmax's eps
NEG = -1e20           # the edge-dropout fill, before the divide by T
FP8_MAX = 448.0       # largest float8 e4m3 value
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def precision(mode: str):
    """TF32 on only for ``"tf32"``; both switches put back after."""
    if mode not in ("f32", "tf32", "fp8"):
        raise ValueError(f"unknown precision {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


FP8_GRAD_MAX = 57344.0  # largest float8 e5m2 value


def _scaled_round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Forward: the operand through float8 e4m3 at a per-tensor scale;
    backward: the incoming gradient through float8 e5m2 at its own scale
    (the usual fp8 training recipe's two formats)."""

    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, FP8_GRAD_MAX)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` computed in fp8: e4m3 forward, e5m2 gradients, each scaled
    per tensor, carried in f32."""
    return _Fp8.apply(x)


def conv(x, w, stride: int, pad: int, mode: str):
    if mode == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    if pad:
        x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(x, w, stride=stride)


# the process group whose ranks hold the global batch's row blocks, inside
# global_batch(); None: the batch is this process's alone
_GLOBAL = {"group": None}


@contextlib.contextmanager
def global_batch(group):
    """Inside, the batch a rank holds is its equal row block of the global
    batch of ``group``'s ranks (``None``: no group)."""
    saved = _GLOBAL["group"]
    _GLOBAL["group"] = group
    try:
        yield
    finally:
        _GLOBAL["group"] = saved


class _GroupSum(torch.autograd.Function):
    """The SUM over a process group; the gradient of each rank's input is
    the SUM of every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _group_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ranks of ``global_batch``'s group
    (differentiable); ``x`` itself without one."""
    group = _GLOBAL["group"]
    if group is None:
        return x
    return _GroupSum.apply(x, group) / dist.get_world_size(group)


def _moments(x):
    """Per channel ``(E[x], E[x^2])`` of ``(B, C, H, W)`` over the batch and
    space, the global batch's inside ``global_batch``."""
    mean, ex2 = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
    if _GLOBAL["group"] is None:
        return mean, ex2
    return _group_mean(torch.cat([mean, ex2])).chunk(2)


def batch_norm(x, sd, name: str, train: bool):
    w, b = sd[name + ".weight"], sd[name + ".bias"]
    if train:
        mean, ex2 = _moments(x)
        var = torch.clamp(ex2 - mean * mean, min=0.0)
    else:
        mean, var = sd[name + ".running_mean"], sd[name + ".running_var"]
    mul = torch.rsqrt(var + BN_EPS) * w
    return (x - mean[:, None, None]) * mul[:, None, None] + b[:, None, None]


STAGES = (("layer1", 1), ("layer2", 2), ("layer3", 1), ("layer4", 1))


def _stem(sd, p, x, train, mode):
    x = conv(x, sd[p + "conv1.weight"], 2, 3, mode)
    x = F.relu(batch_norm(x, sd, p + "bn1", train))
    return F.max_pool2d(x, 3, stride=2, padding=1)


def _block(sd, q, s, x, train, mode):
    y = conv(x, sd[q + "conv1.weight"], s, 1, mode)
    y = F.relu(batch_norm(y, sd, q + "bn1", train))
    y = conv(y, sd[q + "conv2.weight"], 1, 1, mode)
    y = batch_norm(y, sd, q + "bn2", train)
    if q + "downsample.0.weight" in sd:
        x = batch_norm(conv(x, sd[q + "downsample.0.weight"], s, 0, mode),
                       sd, q + "downsample.1", train)
    return F.relu(y + x)


def _bottleneck(sd, q, s, x, train, mode):
    """torchvision's Bottleneck: 1x1, 3x3 with the block's stride, 1x1 to
    four times the width, each with its BN; the projection where its
    weights are; ReLU of the sum."""
    y = conv(x, sd[q + "conv1.weight"], 1, 0, mode)
    y = F.relu(batch_norm(y, sd, q + "bn1", train))
    y = conv(y, sd[q + "conv2.weight"], s, 1, mode)
    y = F.relu(batch_norm(y, sd, q + "bn2", train))
    y = conv(y, sd[q + "conv3.weight"], 1, 0, mode)
    y = batch_norm(y, sd, q + "bn3", train)
    if q + "downsample.0.weight" in sd:
        x = batch_norm(conv(x, sd[q + "downsample.0.weight"], s, 0, mode),
                       sd, q + "downsample.1", train)
    return F.relu(y + x)


def trunk(sd, x, *, train: bool, mode: str = "f32",
          prefix: str = "encoder.model."):
    """``(B, 3, H, W)`` -> ``(B, C, H/8, W/8)``: the stages whose weights
    ``sd`` holds, each block a BasicBlock or a Bottleneck as its weights
    say. Where gradients are taken, the stem and each block keep only
    their input and compute again in the backward pass
    (``torch.utils.checkpoint``: the same batch moments, the same values),
    so that a batch of 32 clips fits one card."""
    p = prefix
    saving = torch.is_grad_enabled()

    def run(fn, *args):
        if saving:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    x = run(lambda t: _stem(sd, p, t, train, mode), x)
    for stage, stride in STAGES:
        b = 0
        while f"{p}{stage}.{b}.conv1.weight" in sd:
            q, s = f"{p}{stage}.{b}.", stride if b == 0 else 1
            block = _bottleneck if q + "conv3.weight" in sd else _block
            x = run(lambda t, q=q, s=s, block=block:
                    block(sd, q, s, t, train, mode), x)
            b += 1
    return x


def l2_normalize(x, dim: int = -1):
    """``x / max(|x|, 1e-12)``; an all-zero vector (an absent superpixel
    slot) stays zero with a zero gradient."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    nonzero = sq > 0
    safe = torch.where(nonzero, sq, torch.ones_like(sq))
    out = x / torch.clamp(torch.sqrt(safe), min=1e-12)
    return torch.where(nonzero, out, torch.zeros_like(out))


def head(sd, feats):
    """The projection head: its Linears (no bias) with ReLU between."""
    i = 0
    while f"selfsim_fc.{i}.weight" in sd:
        if i:
            feats = F.relu(feats)
        feats = feats @ sd[f"selfsim_fc.{i}.weight"].T
        i += 2
    return l2_normalize(feats, dim=-1)


def normalize_frames(unit: torch.Tensor) -> torch.Tensor:
    """Frames in [0, 1], channels last -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=unit.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=unit.device)
    return (unit - mean) / std


def patch_nodes(sd, x, *, mode: str = "f32"):
    """Patches ``(B, T, N, h, w, 3)`` -> ``q (B, C, T, N)``: each patch's
    map averaged over space, projected, L2-normalized."""
    B, T, N = x.shape[:3]
    imgs = x.transpose(1, 2).reshape(B * N * T, *x.shape[3:])
    maps = trunk(sd, imgs.permute(0, 3, 1, 2), train=True, mode=mode)
    feats = head(sd, maps.mean(dim=(2, 3)).reshape(B * N, T, -1))
    return feats.reshape(B, N, T, -1).permute(0, 3, 2, 1)


def dilate_l1(masks: torch.Tensor, radius: int) -> torch.Tensor:
    """Exact L1-ball dilation of 0/1 masks ``(..., h, w)``: ``radius``
    passes of the unit diamond (a pixel and its four neighbours), zero
    outside the frame."""
    y = masks
    for _ in range(radius):
        z = y.clone()
        z[..., 1:, :] = torch.maximum(z[..., 1:, :], y[..., :-1, :])
        z[..., :-1, :] = torch.maximum(z[..., :-1, :], y[..., 1:, :])
        z[..., :, 1:] = torch.maximum(z[..., :, 1:], y[..., :, :-1])
        z[..., :, :-1] = torch.maximum(z[..., :, :-1], y[..., :, 1:])
        y = z
    return y


def pool_weights(labels: torch.Tensor, n_slots: int, feat_hw, *,
                 dilation_kernel_size: int | None):
    """Superpixel ids ``(B, T, h, w)`` -> ``(B, T, H, W, SP)`` weights:
    each slot's (dilated) pixel count in each feature cell's window over
    the slot's total (zero for an absent slot)."""
    B, T, h, w = labels.shape
    H, W = feat_hw
    slots = torch.arange(n_slots, device=labels.device)
    onehot = (labels[:, :, None] == slots[:, None, None]).to(torch.float32)
    if dilation_kernel_size:
        onehot = dilate_l1(onehot, dilation_kernel_size // 2)
    counts = onehot.reshape(B, T, n_slots, H, h // H, W, w // W).sum(
        (4, 6)).movedim(2, -1)
    return counts / (counts.sum(dim=(2, 3), keepdim=True) + EPS)


def superpixel_nodes(sd, frames, labels, *, n_slots: int,
                     dilation_kernel_size: int | None, mode: str = "f32"):
    """Whole frames ``(B, T, h, w, 3)`` (normalized) and their superpixel
    ids -> ``q (B, C, T, SP)``: the maps pooled by slot weights."""
    B, T = frames.shape[:2]
    maps = trunk(sd, frames.reshape(B * T, *frames.shape[2:]).permute(
        0, 3, 1, 2), train=True, mode=mode)
    _, C, H, W = maps.shape
    maps = maps.permute(0, 2, 3, 1).reshape(B, T, H, W, C)
    wts = pool_weights(labels, n_slots, (H, W),
                       dilation_kernel_size=dilation_kernel_size)
    sp = torch.einsum("bthws,bthwc->btsc", wts, maps)
    return head(sd, sp).permute(0, 3, 1, 2)


def zero_softmax(x, dim: int = -1):
    u = torch.square(torch.expm1(x))
    return u / (u.sum(dim=dim, keepdim=True) + ZSM_EPS)


def walk_loss(q, temperature: float, m12, m21):
    """The palindrome loss of ``q (B, C, T, N)`` with ZeroSoftmax and the
    edge-dropout masks ``(B, T-1, N, N)`` (True: dropped): for each cycle
    length i = 1 .. T-2, the cross-entropy of the out-and-back product
    against the identity, averaged over rows and clips; the cycles'
    mean."""
    A = torch.einsum("bctn,bctm->btnm", q[:, :, :-1], q[:, :, 1:])
    P = zero_softmax(torch.where(m12, torch.full_like(A, NEG), A)
                     / temperature)
    Q = zero_softmax(torch.where(m21, torch.full_like(A, NEG),
                                 A.transpose(-1, -2)) / temperature)
    fwd, back = P[:, 0], Q[:, 0]
    losses = []
    for i in range(1, A.shape[1]):
        fwd, back = fwd @ P[:, i], Q[:, i] @ back
        logits = torch.log(fwd @ back + EPS)
        losses.append((torch.logsumexp(logits, dim=-1)
                       - torch.diagonal(logits, dim1=-2, dim2=-1)).mean())
    return torch.stack(losses).mean()


def dropout_masks(shape, rate: float, generator: torch.Generator, device):
    """``(m12, m21)``: two Bernoulli(``rate``) draws of ``shape``, in that
    order, from ``generator``."""
    return tuple(torch.rand(shape, generator=generator, device=device) < rate
                 for _ in range(2))


def adam_steps(weights: dict, batches, loss_fn, *, lr: float,
               betas=(0.9, 0.999), eps: float = 1e-8):
    """Adam (no weight decay) on every float leaf of ``weights`` but the BN
    running statistics, one step a batch: ``loss_fn(sd, i, batch)``.
    Returns the losses, each leaf's gradient at step 1 and the leaves after
    the last step (``{name: tensor}``). Inside ``global_batch``, each
    loss and gradient is the mean of the ranks' (equal row blocks: the
    global batch's)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()
              if v.is_floating_point() and "running_" not in k}
    sd = dict(weights, **leaves)
    opt = torch.optim.Adam(list(leaves.values()), lr=lr, betas=betas,
                           eps=eps, weight_decay=0.0)
    losses, grad1 = [], None
    for i, batch in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(sd, i, batch)
        loss.backward()
        if _GLOBAL["group"] is not None:
            with torch.no_grad():
                for v in leaves.values():
                    if v.grad is None:
                        v.grad = torch.zeros_like(v)
                flat = _group_mean(torch.cat([v.grad.reshape(-1)
                                             for v in leaves.values()]))
                for v, g in zip(leaves.values(),
                                flat.split([v.numel()
                                            for v in leaves.values()])):
                    v.grad.copy_(g.view_as(v))
                loss = _group_mean(loss.detach())
        if i == 0:
            grad1 = {k: (v.grad.detach().clone() if v.grad is not None
                         else torch.zeros_like(v)) for k, v in leaves.items()}
        opt.step()
        losses.append(float(loss.detach()))
    return losses, grad1, {k: v.detach() for k, v in leaves.items()}
