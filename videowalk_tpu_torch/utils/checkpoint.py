"""Checkpoints in the reference ``.pth`` format, and full-state resume.

- ``state_from_flax``: the weight carrier from the JAX package. It takes a
  flax ``{params, batch_stats}`` tree (nested dicts of numpy arrays) of a
  ``CRW`` or a ``CRWTeacherStudent`` and returns this package's
  ``state_dict`` with the reference's names: HWIO -> OIHW, dense (in, out)
  -> (out, in), ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_*``,
  ``layerK_i`` -> ``layerK.i``, the teacher-student towers -> ``encoder``,
  ``selfsim_fc``, ``teacher.encoder``, ``teacher.selfsim_fc``, and a
  ``num_batches_tracked`` per BN. The mapping follows
  ``videowalk_tpu/utils/checkpoint.py::flax_to_torch_state``.
- ``save_checkpoint``: the reference's checkpoint dict ``{model,
  optimizer, lr_scheduler, epoch, args}`` (code/train.py:279-289), which
  the reference and the JAX package's ``torch_to_flax_state`` read; its
  ``lr_scheduler`` also holds the JAX trainer's ``step``, ``milestones`` and
  ``gamma``, and ``resume_schedule`` reads the step of either package's
  file.
- ``load_checkpoint``: ``torch.load`` of a trusted local ``.pth``.
- ``partial_load``: reference ``partial_load`` semantics (key rename shim,
  substring skip list, report of skipped and loaded keys).
- ``save_train_state`` / ``load_train_state``: the whole training state
  (model, optimizer, scheduler, step count and the ``torch.Generator`` of
  edge dropout and featdrop) in one ``torch.save``, so a resumed run takes
  the steps an uninterrupted one would. It stands in for the JAX package's
  orbax resume.
"""

from __future__ import annotations

import bisect
from collections import Counter
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_LEAF_MAP = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}

_MODULE_MAP = {
    # teacher-student towers -> the reference's CRWTeacherStudent names
    # (code/teacherstudent.py:316-321)
    "student_encoder": ("encoder",),
    "student_head": ("selfsim_fc",),
    "teacher_encoder": ("teacher", "encoder"),
    "teacher_head": ("teacher", "selfsim_fc"),
    "head": ("selfsim_fc",),
    "downsample_conv": ("downsample", "0"),
    "downsample_bn": ("downsample", "1"),
}


def _module_path(parts: tuple[str, ...]) -> tuple[str, ...]:
    out: list[str] = []
    for p in parts:
        if p in _MODULE_MAP:
            out.extend(_MODULE_MAP[p])
        elif p.startswith("layer") and "_" in p:
            out.extend(p.split("_"))
        elif p.startswith("fc") and p[2:].isdigit():
            out.append(str(2 * int(p[2:])))   # Linear/ReLU Sequential index
        else:
            out.append(p)
    return tuple(out)


def _flatten(tree: Mapping, prefix=()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def state_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax CRW or CRWTeacherStudent variables (numpy leaves) ->
    reference-named state_dict."""
    state: dict[str, torch.Tensor] = {}
    bn_prefixes = set()
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})).items():
            *mods, leaf_name = path
            torch_leaf = _LEAF_MAP.get((collection, leaf_name))
            if torch_leaf is None:
                raise KeyError(f"unmapped flax leaf: {collection}/{path}")
            arr = np.asarray(leaf)
            if leaf_name == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)           # HWIO -> OIHW
            elif leaf_name == "kernel" and arr.ndim == 2:
                arr = arr.T                               # (in,out) -> (out,in)
            tpath = _module_path(tuple(mods))
            state[".".join(tpath + (torch_leaf,))] = torch.from_numpy(
                np.array(arr, dtype=np.float32))   # a writable copy
            if collection == "batch_stats":
                bn_prefixes.add(".".join(tpath))
    for p in sorted(bn_prefixes):
        state[f"{p}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return state


def scheduler_state(scheduler) -> dict:
    """The ``lr_scheduler`` entry of a ``.pth``: the scheduler's own
    ``state_dict`` with the JAX package's keys beside it (``step``, the
    updates taken; ``milestones`` as a sorted list; ``gamma``), so that the
    JAX trainer resumes the file at its step (``videowalk_tpu/cli/train.py``
    reads ``lr_scheduler["step"]``). As in the JAX package's file, these
    keys do not survive torch's ``LRScheduler.load_state_dict`` (``step``
    would shadow the method): resume through ``resume_schedule``."""
    sd = scheduler.state_dict()
    milestones = sd.get("milestones") or {}
    return {**sd, "step": int(scheduler.last_epoch),
            "milestones": sorted(Counter(milestones).elements()),
            "gamma": sd.get("gamma")}


def resume_schedule(scheduler, lr_scheduler: Mapping | None) -> int | None:
    """Put ``scheduler`` (a ``MultiStepLR`` bound to its optimizer, built
    with the run's milestones and gamma) at the step stored in a ``.pth``'s
    ``lr_scheduler`` entry (written by this package or the JAX package) and
    set its optimizer's LR to that step's; returns the step, or None when
    the entry has none. As in the JAX trainer, only the step is read: the
    schedule's shape comes from the run's flags."""
    if not lr_scheduler or "step" not in lr_scheduler:
        return None
    step = int(lr_scheduler["step"])
    scale = scheduler.gamma ** bisect.bisect_right(
        sorted(scheduler.milestones.elements()), step)
    scheduler.last_epoch = step
    for group, base in zip(scheduler.optimizer.param_groups,
                           scheduler.base_lrs):
        group["lr"] = base * scale
    scheduler._last_lr = [g["lr"] for g in scheduler.optimizer.param_groups]
    return step


def save_checkpoint(path: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer | None = None,
                    lr_scheduler=None, epoch: int = 0, args=None) -> None:
    """Write the reference's checkpoint dict to ``path``: ``model`` (the
    reference-named ``state_dict`` as CPU tensors), ``optimizer`` (its
    ``state_dict`` and ``type``, the optimizer's class name, or None),
    ``lr_scheduler`` (``scheduler_state``, or None), ``epoch`` and
    ``args``. JAX package: ``utils/checkpoint.py:227``.

    ``type`` also keeps the JAX trainer from taking this state for optax's:
    it converts the entry's leaves to arrays and skips the entry when one
    fails, as the name does (``videowalk_tpu/cli/train.py:525-530``)."""
    torch.save({
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": None if optimizer is None else {
            **optimizer.state_dict(),
            "type": f"{type(optimizer).__module__}."
                    f"{type(optimizer).__qualname__}"},
        "lr_scheduler": (None if lr_scheduler is None
                         else scheduler_state(lr_scheduler)),
        "epoch": epoch,
        "args": {} if args is None else args,
    }, path)


def load_checkpoint(path: str) -> dict:
    """Read a ``.pth`` checkpoint. Writers of this format pickle non-tensor
    fields (args, schedule state), so this loads with
    ``weights_only=False``: use it on trusted local files only."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _rename_shim(key: str) -> str:
    """Reference test-time rename: 'conv1.1.weight' -> 'conv1.weight'
    (older Sequential(pad, conv) layout), plus DataParallel 'module.'
    prefix stripping."""
    if key.startswith("module."):
        key = key[len("module."):]
    for conv in ("conv1", "conv2"):
        key = key.replace(f"{conv}.1.weight", f"{conv}.weight")
    return key


def partial_load(torch_state: Mapping[str, Any], model: nn.Module,
                 skip_keys=(), verbose: bool = True) -> list[str]:
    """Load the entries of ``torch_state`` whose (renamed) key exists in
    ``model`` with the same shape and contains no ``skip_keys`` substring;
    returns the loaded keys. Reference ``code/utils/__init__.py:230-245``."""
    own = model.state_dict()
    state = {_rename_shim(k): v for k, v in torch_state.items()}
    loaded = {}
    for key, val in state.items():
        if key not in own or any(sk in key for sk in skip_keys):
            continue
        val = torch.as_tensor(np.asarray(val) if not torch.is_tensor(val) else val)
        if tuple(val.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch loading {key}: "
                             f"{tuple(val.shape)} vs {tuple(own[key].shape)}")
        loaded[key] = val
    model.load_state_dict(loaded, strict=False)
    if verbose:
        skipped = [k for k in state if k not in loaded
                   and not k.endswith("num_batches_tracked")]
        print("\nSkipped keys: ", skipped)
        print("\nLoading keys: ", [k for k in loaded
                                   if not k.endswith("num_batches_tracked")])
    return list(loaded)


def save_train_state(path: str, state, generator: torch.Generator | None
                     = None) -> None:
    """Write ``state`` (a ``parallel.TrainState``: model, optimizer,
    scheduler, step) and ``generator``'s state to ``path``."""
    torch.save({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
        "generator": None if generator is None else generator.get_state(),
    }, path)


def load_train_state(path: str, state, generator: torch.Generator | None
                     = None):
    """Restore what ``save_train_state`` wrote into ``state`` (built as the
    saved one was: same model, optimizer, schedule, frozen prefixes) and
    ``generator``, in place; returns ``state``. Tensors land on the
    devices of ``state``'s own. A trusted local file only (see
    ``load_checkpoint``)."""
    ckpt = load_checkpoint(path)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = ckpt["step"]
    if generator is not None:
        if ckpt["generator"] is None:
            raise ValueError(f"{path} holds no generator state")
        generator.set_state(ckpt["generator"])
    return state
