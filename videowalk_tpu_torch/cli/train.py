"""Trainer (counterpart of ``videowalk_tpu/cli/train.py``; reference
``code/train.py``).

    python -m videowalk_tpu_torch.cli.train --data-path /data/kinetics/ \\
        --frame-aug grid --dropout 0.1 --clip-len 4 --temp 0.05 \\
        --model-type scratch --batch-size 6 --lr 0.0003 --prob 0.7 \\
        --sp-method slic --num-sp 36 --compactness 50 --dilate-superpixels \\
        --dilation-kernel-shape L1 --dilation-kernel-size 55 --epochs 20 \\
        --sp-backend device --dtype bfloat16 --augs-backend device

dataset (a Kinetics tree, an image folder or a filelist) + metadata cache
-> ``RandomClipSampler`` -> threaded loader -> prefetch to the card ->
``CRW`` or ``CRWTeacherStudent`` -> Adam under a per-step MultiStepLR ->
the epoch loop: a Bernoulli choice per step between the patch path and the
superpixel path (drawn on the host from ``RandomState(seed + epoch)`` in
the JAX trainer's order), device augmentations, the superpixel ids made by
SLIC on the card (``--sp-backend device``) or by the loader on the host
(``--sp-backend host``: SLIC, Felzenszwalb or a per-clip mix of both),
the loss and LR read only every ``--print-freq`` steps, stochastic
(p=0.005) and per-epoch ``.pth`` checkpoints, resume and partial reload,
``--visualize`` (the loss and each metric's mean every step, to wandb or
``<logs-dir>/metrics.jsonl``) and ``--profile-dir`` (a ``torch.profiler``
trace of steps 5-9 of the run's first epoch, with the table of the spans
of ``utils/profile.py``: the loop's ``data_wait``, ``augs``, ``fetch`` and
``checkpoint`` beside ``slic``, the ``step`` and its layers). It runs on
the card unless ``--device cpu`` is given; there every kernel takes its
plain version.

Data parallel, one process per card (``parallel/multihost.py``):

    torchrun --nproc-per-node N -m videowalk_tpu_torch.cli.train \\
        --distributed ...

or ``--distributed --coordinator-address HOST:PORT --num-processes N
--process-id I`` on each process; ``--data-parallel`` alone on a host with
N > 1 visible cards spawns the N workers itself. ``--batch-size`` is the
global batch; each rank loads its ``batch // world`` clips from its sampler
shard, BN's moments and the gradients span the global batch, the random
draws are the global batch's rows (``core/rng.py``), and rank 0 alone
writes checkpoints, ``--visualize`` logs and the ``--profile-dir`` trace.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from videowalk_tpu_torch.core.rng import GlobalBatchGenerator
from videowalk_tpu_torch.data.augs import RawClipTransform, get_train_transforms
from videowalk_tpu_torch.data.clips import RandomClipSampler, VideoClipIndex
from videowalk_tpu_torch.data.image_folder import ImageFolder, is_image_folder
from videowalk_tpu_torch.data.kinetics import Kinetics400
from videowalk_tpu_torch.data.loader import DataLoader
from videowalk_tpu_torch.data.prefetch import DevicePrefetcher
from videowalk_tpu_torch.data.video import VideoList
from videowalk_tpu_torch.models import CRW, CRWConfig, CRWTeacherStudent
from videowalk_tpu_torch.models.resnet import remat_stage_set
from videowalk_tpu_torch.ops.augs_device import train_transform_device
from videowalk_tpu_torch.ops.slic import slic_fused
from videowalk_tpu_torch.parallel import (TrainState, create_train_state,
                                          make_optimizer, make_train_step,
                                          multihost)
from videowalk_tpu_torch.utils.arguments import check_supported_train
from videowalk_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  partial_load,
                                                  resume_schedule,
                                                  save_checkpoint)
from videowalk_tpu_torch.utils.device import resolve_device
from videowalk_tpu_torch.utils.pretrained import (PRETRAINED_TYPES,
                                                  apply_pretrained_encoder)
from videowalk_tpu_torch.utils.meters import MetricLogger, SmoothedValue
from videowalk_tpu_torch.utils.profile import Trace, span
from videowalk_tpu_torch.utils.visualize import Visualize

# --steps-per-epoch's "unlimited" default: at or above it the flag was not
# set and the shortfall guard is off
_STEPS_UNLIMITED = int(1e10)


def model_config(args) -> CRWConfig:
    return CRWConfig(
        model_type=args.model_type,
        remove_layers=tuple(args.remove_layers),
        head_depth=args.head_depth,
        temperature=args.temp,
        edgedrop_rate=args.dropout,
        featdrop_rate=args.featdrop,
        flip=args.flip,
        sk_targets=args.sk_targets,
        zero_diagonal=args.zero_diagonal,
        head_bias=args.teacher_student,
        use_zero_softmax=not args.teacher_student,
        max_sp_num=args.max_sp_num,
        dilate_superpixels=args.dilate_superpixels,
        dilation_kernel_shape=args.dilation_kernel_shape,
        dilation_kernel_size=args.dilation_kernel_size,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        remat=args.remat,
        remat_stages=args.remat_stages,
    )


def resolve_remat_args(args) -> None:
    """``--remat-stages`` at startup, in place (the JAX
    ``resolve_remat_args``): an explicit stage list is checked now, so a
    typo fails before any step, and is inert, with a warning, without
    ``--remat``; bare ``--remat`` takes ``layer1``, the JAX package's
    default (its batch-32 ladder's winner, measured on a TPU and not yet on
    the card); ``--remat-stages all`` is full remat."""
    if args.remat_stages is not None:
        remat_stage_set(args.remat_stages)
        if not args.remat:
            print("WARNING: --remat-stages is inert without --remat "
                  "(selective remat only chooses WHICH stages remat)",
                  flush=True)
    elif args.remat:
        args.remat_stages = "layer1"
        print("NOTE: --remat without --remat-stages uses 'layer1' (the JAX "
              "package's measured default, a TPU result). Pass "
              "--remat-stages all for full remat if activations do not "
              "fit.", flush=True)


def make_dataset(args, transform):
    """A Kinetics-style video tree (``<path>/train_256`` or
    ``val_256`` under ``--fast-test``, else ``<path>`` itself), an
    ``ImageFolder`` where that directory holds class folders of images
    (and ``--data-path`` does not name kinetics), or a ``VideoList``
    filelist when ``--data-path`` is a file."""
    traindir = os.path.join(
        args.data_path, "train_256" if not args.fast_test else "val_256")
    root = traindir if os.path.isdir(traindir) else args.data_path
    if "kinetics" not in args.data_path.lower() and is_image_folder(root):
        return ImageFolder(
            root, clip_len=args.clip_len, transform=transform,
            sp_method=args.sp_method, num_components=args.num_sp,
            prob=args.prob, randomise_superpixels=args.randomise_superpixels,
            randomise_superpixels_range=args.randomise_superpixels_range,
            sp_backend=args.sp_backend, seed=args.seed)
    if ("kinetics" in args.data_path.lower() or os.path.isdir(traindir)
            or os.path.isdir(args.data_path)):
        cached = None
        if args.cache_dataset and os.path.exists(args.cache_path):
            print(f"Loading dataset metadata from {args.cache_path}")
            cached = VideoClipIndex.load_metadata(args.cache_path)
        ds = Kinetics400(
            root,
            frames_per_clip=args.clip_len,
            step_between_clips=1,
            frame_rate=args.frame_skip,
            transform=transform,
            _precomputed_metadata=cached,
            sp_method=args.sp_method,
            num_components=args.num_sp,
            prob=args.prob,
            randomise_superpixels=args.randomise_superpixels,
            randomise_superpixels_range=args.randomise_superpixels_range,
            sp_backend=args.sp_backend,
            seed=args.seed,
        )
        if cached is None and args.cache_path and multihost.is_primary():
            # one writer: on a shared file system every rank would write
            # the same file at once
            os.makedirs(os.path.dirname(args.cache_path) or ".", exist_ok=True)
            ds.video_clips.save_metadata(args.cache_path)
            print(f"Saved dataset metadata to {args.cache_path}")
        return ds
    return VideoList(filelist=args.data_path, clip_len=args.clip_len,
                     is_train=True, frame_gap=args.frame_skip,
                     transform=transform, random_clip=True, seed=args.seed)


def check_step_shortfall(args, epoch: int, delivered: int) -> None:
    """An explicit ``--steps-per-epoch`` is a step budget: an epoch whose
    loader delivers fewer batches warns, or raises under
    ``--strict-steps``."""
    if not (args.steps_per_epoch < _STEPS_UNLIMITED
            and delivered < args.steps_per_epoch):
        return
    msg = (f"epoch {epoch} delivered {delivered} batches but "
           f"--steps-per-epoch requested {args.steps_per_epoch}: the "
           f"loader is shorter than the request, so total trained steps "
           f"fall short by the same ratio. Size --epochs from the real "
           f"epoch length (printed at loader creation), or add data / "
           f"raise --clips-per-video.")
    if getattr(args, "strict_steps", False):
        raise RuntimeError(msg)
    print("WARNING: " + msg, flush=True)


@dataclasses.dataclass
class Training:
    """What ``build`` makes and each epoch uses. ``step`` is
    ``make_train_step()``'s (both paths; the superpixel path passes
    ``sp_mask=``); ``step_gen`` draws edge dropout and featdrop,
    ``aug_gen`` the device augmentations, both on the state's device;
    ``vis`` is ``--visualize``'s logger (None without it)."""

    state: TrainState
    step: Callable
    loader: Iterable
    dataset: Any
    step_gen: torch.Generator
    aug_gen: torch.Generator
    checkpoint_fn: Callable | None
    device_slic_fn: Callable
    vis: Visualize | None = None


def _on(x, device: torch.device) -> torch.Tensor:
    """A batch leaf as a tensor on ``device``: a prefetched one is there
    already; a host one is copied (from pinned memory, without a sync)."""
    if torch.is_tensor(x):
        return x.to(device, non_blocking=True)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def seed_step_streams(run: Training, seed: int, step: int) -> None:
    """Key the edge-dropout/featdrop stream and the device-aug stream of the
    next step by ``(seed, global step)``, as the JAX trainer folds the
    global step into its keys: a resumed run draws what the uninterrupted
    run drew at the same step. Seeding a CUDA generator waits for nothing."""
    for gen, stream in ((run.step_gen, 1234), (run.aug_gen, 1235)):
        gen.manual_seed(hash((seed + stream, step)) & 0xFFFF_FFFF_FFFF_FFFF)


def train_one_epoch(args, run: Training, epoch: int) -> TrainState:
    """One epoch of ``run``: at most ``--steps-per-epoch`` steps, the
    epoch's checkpoint at the end. Nothing in a step waits for the card:
    the loss and LR are read every ``--print-freq`` steps and on the last
    one, where a non-finite loss aborts (``--visualize`` reads them every
    step). Under ``--profile-dir``, steps 5-9 of the run's first epoch
    (``--start-epoch``) are traced; the trace is written however the epoch
    ends."""
    state = run.state
    metric_logger = MetricLogger(delimiter="  ")
    metric_logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value}"))
    metric_logger.add_meter("clips/s",
                            SmoothedValue(window_size=10, fmt="{value:.3f}"))
    header = f"Epoch: [{epoch}]"
    # the path choices, n_active draws and checkpoint coins, in the JAX
    # trainer's order
    host_rng = np.random.RandomState(args.seed + epoch)
    total_steps = min(args.steps_per_epoch, len(run.loader))
    if run.vis is not None:
        run.vis.wandb_init(state.model)
    trace = (Trace(args.profile_dir, f"train_epoch{epoch}_steps5-9",
                   state.device)
             if (args.profile_dir and epoch == args.start_epoch
                 and multihost.is_primary()) else None)
    try:
        delivered = _epoch_steps(args, run, epoch, metric_logger, header,
                                 host_rng, total_steps, trace)
    finally:
        if trace is not None:
            trace.stop()
    check_step_shortfall(args, epoch, delivered)
    if run.checkpoint_fn is not None:
        run.checkpoint_fn(state, epoch)
    return state


def _epoch_steps(args, run: Training, epoch: int, metric_logger, header: str,
                 host_rng, total_steps: int, trace: Trace | None) -> int:
    """The steps of ``train_one_epoch``; returns the batches delivered."""
    state = run.state
    dev = state.device
    fetch_every = max(1, args.print_freq)
    window_clips, window_t0 = 0, time.perf_counter()
    device_augs = args.augs_backend == "device"
    world = multihost.world()     # clips/s counts the global batch
    delivered = 0
    for step_i, (views, sp_mask, _label) in enumerate(
            metric_logger.log_every(run.loader, args.print_freq, header,
                                    total=total_steps)):
        if step_i >= args.steps_per_epoch:
            break
        delivered += 1
        if trace is not None:
            if step_i == 5:
                trace.start()
            elif step_i == 10:
                trace.stop()
        seed_step_streams(run, args.seed, state.step)
        if device_augs:
            with span("augs"):
                views = train_transform_device(
                    _on(views["raw"], dev), run.aug_gen,
                    img_size=args.img_size,
                    patch_size=int(args.patch_size[0]),
                    frame_aug=args.frame_aug or "",
                    frame_transforms=args.frame_transforms)
        grid = bool(host_rng.choice([True, False],
                                    p=[args.prob, 1 - args.prob]))
        if grid or args.teacher_student:
            batch = _on(views["grid"], dev)
            metrics = run.step(state, batch, run.step_gen)
        else:
            if args.sp_backend == "device":
                mask = run.device_slic_fn(_on(views["whole_unnorm"], dev),
                                          host_rng)
            else:           # the loader's ids (data/superpixels.py)
                mask = _on(sp_mask, dev)
            batch = _on(views["whole"], dev)
            metrics = run.step(state, batch, run.step_gen, sp_mask=mask)
        window_clips += batch.shape[0] * world

        if run.vis is not None:
            # the reference's per-step logging (code/train.py:71-73): a
            # fetch every step, so opt-in
            run.vis.log(dict(loss=float(metrics["loss"])))
            run.vis.log({k: float(np.asarray(v.detach().cpu()).mean())
                         for k, v in metrics.items() if k != "loss"})

        if step_i % fetch_every == 0 or step_i + 1 >= total_steps:
            with span("fetch"):
                loss = float(metrics["loss"])   # waits for this step
            if not np.isfinite(loss):
                where = args.output_dir or "<no --output-dir>"
                raise FloatingPointError(
                    f"non-finite loss {loss} at epoch {epoch} step {step_i} "
                    f"(global step {state.step}). Re-run with --debug-nans "
                    f"to locate the producing op, or lower --lr / raise "
                    f"--temp; the last checkpoint in {where} is intact.")
            # the LR of the next update, as the JAX trainer's
            # multistep_lr(global_step)
            metric_logger.update(loss=loss,
                                 lr=state.optimizer.param_groups[0]["lr"])
            metric_logger.meters["clips/s"].update(
                window_clips / max(time.perf_counter() - window_t0, 1e-9))
            window_clips, window_t0 = 0, time.perf_counter()

        # stochastic checkpointing (reference train.py:76-77)
        if (run.checkpoint_fn is not None
                and host_rng.random_sample() < 0.005):
            with span("checkpoint"):
                run.checkpoint_fn(state, epoch)
    return delivered


def build(args, device: torch.device, dataset=None) -> Training:
    """The dataset (``make_dataset`` unless one is given: any object with
    the ``Kinetics400`` item contract), loader, prefetcher, model, train
    state, schedule, generators and the checkpoint and SLIC functions."""
    print("Preparing training dataloader", end="\n" + "-" * 100 + "\n")
    st = time.time()
    if dataset is None:
        transform = (RawClipTransform(args.img_size)
                     if args.augs_backend == "device"
                     else get_train_transforms(args))
        dataset = make_dataset(args, transform)
    if hasattr(dataset, "set_compactness"):
        print("Set Compactness at:", args.compactness)
        dataset.set_compactness(args.compactness)
    print("Took", time.time() - st)

    print("Creating data loaders", end="\n" + "-" * 100 + "\n")
    sampler = (RandomClipSampler(dataset.video_clips, args.clips_per_video,
                                 seed=args.seed)
               if hasattr(dataset, "video_clips") else None)
    # under --distributed the group is attached even at world size 1 (its
    # collectives then return their input: the plain step, bitwise)
    group = (torch.distributed.group.WORLD
             if torch.distributed.is_initialized() else None)
    world, rank = multihost.world(), multihost.rank()
    if args.batch_size % world:
        raise ValueError(f"--batch-size {args.batch_size} (the global batch) "
                         f"must be divisible by the {world} processes")
    # each rank loads its batch // world clips from its disjoint shard
    loader = DataLoader(dataset, batch_size=args.batch_size // world,
                        sampler=sampler, num_workers=max(1, args.workers // 2),
                        shard=(rank, world) if world > 1 else None)
    print(f"Epoch length: {len(loader)} batches", flush=True)
    if sampler is not None:
        # the JAX trainer initializes its model from the first clip of one
        # sampler pass; drawing that pass here too keeps every epoch's
        # clips equal to the JAX trainer's at the same seed
        next(iter(sampler))

    print("Creating model", end="\n" + "-" * 100 + "\n")
    cfg = model_config(args)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        if args.teacher_student:
            model = CRWTeacherStudent(cfg, alpha=args.alpha_teacher_student)
        else:
            model = CRW(cfg)
    milestones = [len(loader) * m for m in args.lr_milestones]
    optimizer = make_optimizer(args.lr, milestones, args.lr_gamma,
                               optim=args.optim, momentum=args.momentum)
    state = create_train_state(
        model, optimizer, device=device,
        frozen_prefixes=("teacher.",) if args.teacher_student else (),
        group=group)

    if args.model_type in PRETRAINED_TYPES:
        # the reference's make_encoder loads these inside construction
        # (code/utils/__init__.py:300-351); a teacher, a partial reload or
        # a resume below overrides them
        apply_pretrained_encoder(state.model, args.model_type,
                                 args.pretrained_path, verbose=False)
        print(f"Loaded pretrained {args.model_type} encoder weights from "
              f"{args.pretrained_path}", flush=True)

    if args.teacher_student:
        # the reference loads the teacher unconditionally
        # (teacherstudent.py:321-328): a random frozen teacher would train
        # to plausible-looking losses
        if not os.path.isfile(args.path_to_pretrained):
            raise FileNotFoundError(
                f"--teacher-student needs a pretrained teacher checkpoint; "
                f"--path-to-pretrained={args.path_to_pretrained!r} is not a "
                f"file")
        ckpt = load_checkpoint(args.path_to_pretrained)
        partial_load({"teacher." + k: v for k, v in ckpt["model"].items()},
                     state.model)

    if args.partial_reload:
        partial_load(load_checkpoint(args.partial_reload)["model"],
                     state.model)

    if args.resume and os.path.isdir(args.resume):
        raise NotImplementedError(
            f"--resume {args.resume!r} is a directory (an orbax checkpoint "
            f"of the JAX package), which this port does not read; resume "
            f"from a .pth")
    if args.resume and os.path.isfile(args.resume):
        ckpt = load_checkpoint(args.resume)
        partial_load(ckpt["model"], state.model, verbose=False)
        opt = ckpt.get("optimizer")
        if isinstance(opt, dict) and "param_groups" in opt:
            state.optimizer.load_state_dict(opt)
        elif opt is not None:
            print(f"optimizer state not restored: {type(opt).__name__} is "
                  f"not a torch optimizer's state (the JAX package writes "
                  f"optax's)", flush=True)
        step = resume_schedule(state.scheduler, ckpt.get("lr_scheduler"))
        if step is not None:
            state.step = step
        args.start_epoch = int(ckpt.get("epoch", -1)) + 1
        print(f"Resumed from {args.resume}: step={state.step}, "
              f"start_epoch={args.start_epoch}", flush=True)
    if sampler is not None:
        # epoch e reads the sampler's pass e + 1: a run that starts at a
        # later epoch skips the passes of the epochs before it
        for _ in range(args.start_epoch):
            iter(sampler)

    def device_slic_fn(unnorm: torch.Tensor, host_rng) -> torch.Tensor:
        if args.randomise_superpixels:
            B, T = unnorm.shape[:2]
            half = args.randomise_superpixels_range // 2
            # drawn for the global batch on every rank (the same host_rng
            # stream); the rank keeps its clips' frames
            n_active = host_rng.randint(args.num_sp - half,
                                        args.num_sp + half, (B * world * T,))
            n_active = n_active[rank * B * T:(rank + 1) * B * T]
            return slic_fused(unnorm, args.max_sp_num, float(args.compactness),
                              n_active=_on(n_active.astype(np.int32),
                                           unnorm.device))
        return slic_fused(unnorm, args.num_sp, float(args.compactness))

    def checkpoint_fn(state_: TrainState, epoch_: int) -> None:
        # the state is replicated: rank 0 alone writes (every rank draws
        # the same stochastic-checkpoint coin)
        if not args.output_dir or not multihost.is_primary():
            return
        ck_args = {k: v for k, v in vars(args).items()
                   if isinstance(v, (int, float, str, bool, list, tuple))}
        for path in (os.path.join(args.output_dir, f"model_{epoch_}.pth"),
                     os.path.join(args.output_dir, "checkpoint.pth")):
            save_checkpoint(path, state_.model, state_.optimizer,
                            state_.scheduler, epoch=epoch_, args=ck_args)

    if args.prefetch > 0:
        # only the views the step reads go to the card
        if args.augs_backend == "device":
            keys = {"raw"}
        else:
            keys = set()
            if args.teacher_student or args.prob > 0:
                keys.add("grid")
            if args.prob < 1 and not args.teacher_student:
                keys.add("whole")
                if args.sp_backend == "device":
                    keys.add("whole_unnorm")
        loader = DevicePrefetcher(loader, args.prefetch, keys=keys,
                                  device=state.device)

    def generator():
        # every rank seeds it alike and keeps its rows of the global draw
        return (GlobalBatchGenerator(state.device, rank, world)
                if group is not None else torch.Generator(state.device))

    run = Training(state=state, step=make_train_step(), loader=loader,
                   dataset=dataset, step_gen=generator(),
                   aug_gen=generator(),
                   checkpoint_fn=checkpoint_fn, device_slic_fn=device_slic_fn,
                   # rank 0 alone logs (reference train.py:238)
                   vis=(Visualize(args)
                        if args.visualize and multihost.is_primary()
                        else None))
    seed_step_streams(run, args.seed, state.step)
    return run


def _data_parallel_worker(local_rank: int, world: int, port: int, args,
                          dataset) -> None:
    args.distributed = True
    args.coordinator_address = f"127.0.0.1:{port}"
    args.num_processes, args.process_id = world, local_rank
    args.device = f"cuda:{local_rank}"
    main(args, dataset)


def spawn_data_parallel(args, dataset=None) -> None:
    """``--data-parallel`` on a host with more than one visible card: one
    worker process per card (``torch.multiprocessing.spawn``), joined over
    NCCL at a free port of 127.0.0.1, each running ``main`` as
    ``--distributed`` rank ``i`` on ``cuda:i`` (the counterpart of the JAX
    trainer's one-process mesh over the local devices)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    world = torch.cuda.device_count()
    print(f"--data-parallel: {world} workers, one per card", flush=True)
    mp.spawn(_data_parallel_worker, args=(world, port, args, dataset),
             nprocs=world, join=True)


def main(args, dataset=None) -> TrainState | None:
    """Train as ``args`` say (``train_args``); returns the train state
    (None where ``--data-parallel`` spawned one worker per card).
    ``dataset`` replaces ``make_dataset``'s (any object with the
    ``Kinetics400`` item contract). Under ``--distributed`` the process
    group is formed first and destroyed on exit."""
    check_supported_train(args)
    resolve_remat_args(args)
    if (args.data_parallel and not args.distributed
            and torch.device(args.device).type == "cuda"
            and torch.cuda.device_count() > 1):
        spawn_data_parallel(args, dataset)
        return None
    if args.distributed:
        multihost.initialize_from_args(args)
        try:
            return _main(args, multihost.local_device(args.device), dataset)
        finally:
            multihost.shutdown()
    return _main(args, args.device, dataset)


def _main(args, device, dataset) -> TrainState:
    device = resolve_device(device)
    if args.teacher_student and args.prob != 1:
        raise ValueError(    # the reference asserts it (train.py:136-137)
            "Teacher-Student training is not yet compatible with "
            "probabilistic sp | patch sampling")

    print("Arguments", end="\n" + "-" * 100 + "\n")
    for arg, value in vars(args).items():
        print(f"{arg} = {value}")
    print("-" * 100)
    print("torch device:", device,
          torch.cuda.get_device_name(device) if device.type == "cuda" else "")

    anomaly = torch.is_anomaly_enabled()
    # the reference's own setting (code/train.py:27), opt-in here: slow
    torch.autograd.set_detect_anomaly(args.debug_nans or anomaly)
    try:
        run = build(args, device, dataset)
        print("Start training", end="\n" + "-" * 100 + "\n")
        start_time = time.time()
        for epoch in range(args.start_epoch, args.epochs):
            if hasattr(run.dataset, "set_epoch"):
                run.dataset.set_epoch(epoch)
            train_one_epoch(args, run, epoch)
        if run.vis is not None:
            run.vis.close()
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
    total = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    print(f"Training time {total}")
    return run.state


if __name__ == "__main__":
    from videowalk_tpu_torch.utils.arguments import train_args

    main(train_args())
