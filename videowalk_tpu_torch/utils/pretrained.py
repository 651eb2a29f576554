"""Pretrained-encoder weight import for the reference's model types
(counterpart of ``videowalk_tpu/utils/pretrained.py``; reference
``code/utils/__init__.py:248-351``).

Each family's published checkpoint is munged to torchvision-resnet names:

- ``imagenet18`` / ``imagenet50``: a torchvision ``state_dict`` (the
  reference downloads it by URL, ``code/resnet.py:57-63``; here it is a
  local file); any DataParallel ``module.`` prefix is stripped.
- ``moco50``: MoCo-v2 ``.pth.tar``: the ``module.encoder_q.*`` keys with
  the prefix stripped (``code/utils/__init__.py:319-324``); the MLP head
  (``fc.0`` / ``fc.2``) has no target in the trunk and is skipped by the
  partial load.
- ``timecycle``: the ``module.encoderVideo.*`` keys, the inflated 3D convs'
  singleton time axis squeezed, ``(O, I, 1, kh, kw) -> (O, I, kh, kw)``
  (``load_tc_model``, ``code/utils/__init__.py:254-270``).
- ``uvc``: the ``module.gray_encoder.*`` keys (``load_uvc_model``,
  ``code/utils/__init__.py:273-282``).
- ``vince``: the ``feature_extractor.module.model.*`` keys
  (``load_vince_model``, ``code/utils/__init__.py:248-251``; never called by
  the reference, kept for its checkpoints).

``apply_pretrained_encoder`` loads the result under the CRW's
``encoder.model.`` and the teacher-student teacher's
``teacher.encoder.model.`` through ``utils/checkpoint.py::partial_load``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from videowalk_tpu_torch.utils.checkpoint import load_checkpoint, partial_load

# model types whose encoders are initialized from a local checkpoint file
PRETRAINED_TYPES = ("imagenet18", "imagenet50", "moco50", "timecycle", "uvc")


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(v)


def _unwrap_state_dict(ckpt: Mapping) -> Mapping[str, Any]:
    """A bare ``state_dict`` or the one under ``state_dict`` / ``model``."""
    for key in ("state_dict", "model"):
        inner = ckpt.get(key) if isinstance(ckpt, Mapping) else None
        if isinstance(inner, Mapping) and inner:
            return inner
    return ckpt


def normalize_imagenet(ckpt: Mapping) -> dict[str, torch.Tensor]:
    """torchvision zoo file: already torchvision-named; strip any
    ``module.`` prefix."""
    state = _unwrap_state_dict(ckpt)
    return {k.removeprefix("module."): _tensor(v) for k, v in state.items()}


def normalize_moco(ckpt: Mapping) -> dict[str, torch.Tensor]:
    """MoCo-v2: the query encoder's keys. Split on the prefix, not a
    positional slice: a re-wrapped file (``model.module.encoder_q.*``)
    would otherwise slice to garbage keys."""
    state = _unwrap_state_dict(ckpt)
    prefix = "module.encoder_q."
    return {k.split(prefix, 1)[1]: _tensor(v) for k, v in state.items()
            if prefix in k}


def normalize_timecycle(ckpt: Mapping) -> dict[str, torch.Tensor]:
    """TimeCycle: the video encoder's keys, 5-D convs with a singleton time
    axis squeezed to 4-D."""
    state = _unwrap_state_dict(ckpt)
    out = {}
    for k, v in state.items():
        if "encoderVideo" not in k:
            continue
        t = _tensor(v)
        if t.dim() == 5 and t.shape[2] == 1:
            t = t.squeeze(2)
        out[k.replace("module.encoderVideo.", "")] = t
    return out


def normalize_uvc(ckpt: Mapping) -> dict[str, torch.Tensor]:
    """UVC: the gray encoder's keys."""
    state = _unwrap_state_dict(ckpt)
    return {k.replace("module.gray_encoder.", ""): _tensor(v)
            for k, v in state.items() if "gray_encoder" in k}


def normalize_vince(ckpt: Mapping) -> dict[str, torch.Tensor]:
    """VINCE: the feature extractor's keys."""
    state = _unwrap_state_dict(ckpt)
    return {k.replace("feature_extractor.module.model.", ""): _tensor(v)
            for k, v in state.items() if "feature_extractor" in k}


_NORMALIZERS = {
    "imagenet18": normalize_imagenet,
    "imagenet50": normalize_imagenet,
    "moco50": normalize_moco,
    "timecycle": normalize_timecycle,
    "uvc": normalize_uvc,
    "vince": normalize_vince,
}


def load_pretrained_state(model_type: str,
                          path: str) -> dict[str, torch.Tensor]:
    """Read a local checkpoint file (trusted: ``load_checkpoint``) and
    normalize its keys to torchvision-resnet names for ``model_type``."""
    if model_type not in _NORMALIZERS:
        raise ValueError(
            f"model_type {model_type!r} has no pretrained schema "
            f"(supported: {sorted(_NORMALIZERS)})")
    state = _NORMALIZERS[model_type](load_checkpoint(path))
    if not state:
        raise ValueError(
            f"{path} contains no keys matching the {model_type!r} schema "
            f"(see videowalk_tpu_torch.utils.pretrained docstring)")
    return state


def apply_pretrained_encoder(model: nn.Module, model_type: str, path: str,
                             verbose: bool = True) -> list[str]:
    """Load the encoder weights of a local checkpoint into ``model`` (a
    ``CRW``: ``encoder.model.*``; a ``CRWTeacherStudent``: also the
    teacher's ``teacher.encoder.model.*``, as the reference builds both
    towers with ``make_encoder``, code/teacherstudent.py:316-328), in
    place; returns the keys loaded. Raises without a path, and when no
    weight matched."""
    if not path:
        raise ValueError(
            f"model_type={model_type!r} initializes its encoder from a "
            f"local checkpoint; pass --pretrained-path (the reference "
            f"downloads these at code/utils/__init__.py:313-330 — no "
            f"network access here)")
    state = load_pretrained_state(model_type, path)
    prefixed = {}
    for prefix in ("encoder.model.", "teacher.encoder.model."):
        prefixed.update({prefix + k: v for k, v in state.items()})
    loaded = partial_load(prefixed, model, verbose=verbose)
    if not any(not k.endswith("num_batches_tracked") for k in loaded):
        raise ValueError(
            f"no encoder weights from {path} matched the model "
            f"(wrong --model-type / corrupt file?)")
    return loaded
