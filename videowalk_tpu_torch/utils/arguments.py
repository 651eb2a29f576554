"""Argument parsers of the eval and train CLIs: the flag surfaces of
``videowalk_tpu/utils/arguments.py::test_args`` and ``::train_args``
(reference ``code/utils/arguments.py``), with ``--device`` defaulting to
``cuda``.

Flags this port does not implement yet are still parsed, so command lines
written for the JAX package's CLI keep their meaning; ``check_supported``
(called by ``cli.test.main``) and ``check_supported_train`` (called by
``cli.train.main``) raise when one is set rather than ignoring it.
"""

from __future__ import annotations

import argparse
import datetime
import os


def check_supported(args) -> None:
    """Raise ``NotImplementedError`` naming every set flag this port does
    not implement."""
    bad = []
    for flag, on in (
            ("--data-parallel", getattr(args, "data_parallel", False)),
            ("--distributed", getattr(args, "distributed", False)),
            ("--prop-backend " + str(getattr(args, "prop_backend", "auto")),
             getattr(args, "prop_backend", "auto") not in ("auto", "sparse"))):
        if on:
            bad.append(flag)
    if bad:
        raise NotImplementedError(
            "not ported to videowalk_tpu_torch yet (see ROADMAP.md): "
            + ", ".join(bad))


def test_args(argv=None):
    """Label-propagation evaluation args."""
    parser = argparse.ArgumentParser(description="Label Propagation")

    parser.add_argument("--workers", default=4, type=int, metavar="N")
    parser.add_argument("--resume", default="", type=str, metavar="PATH",
                        help="path to checkpoint (.pth)")
    parser.add_argument("--manualSeed", type=int, default=777)
    parser.add_argument("--gpu-id", default="0", type=str,
                        help="kept for CLI parity; use --device")
    parser.add_argument("--batchSize", default=1, type=int)
    parser.add_argument("--temperature", default=0.07, type=float)
    parser.add_argument("--topk", default=10, type=int, help="k for kNN")
    parser.add_argument("--radius", default=12, type=float,
                        help="spatial radius for neighbor mask")
    parser.add_argument("--videoLen", default=20, type=int,
                        help="number of context frames")
    parser.add_argument("--cropSize", default=320, type=int,
                        help="resize of test images, -1 for native size")
    parser.add_argument("--filelist", default="davis_vallist.txt", type=str)
    parser.add_argument("--save-path", default="./results", type=str)
    parser.add_argument("--visdom", default=False, action="store_true")
    parser.add_argument("--visdom-server", default="localhost", type=str)
    parser.add_argument("--model-type", default="scratch", type=str)
    parser.add_argument("--head-depth", default=-1, type=int)
    parser.add_argument("--remove-layers", default=["layer4"], nargs="*")
    parser.add_argument("--no-l2", default=False, action="store_true")
    parser.add_argument("--long-mem", default=[0], type=int, nargs="*")
    parser.add_argument("--texture", default=False, action="store_true")
    parser.add_argument("--round", default=False, action="store_true")
    parser.add_argument("--norm_mask", default=False, action="store_true")
    parser.add_argument("--finetune", default=0, type=int)
    parser.add_argument("--pca-vis", default=False, action="store_true")
    parser.add_argument("--pretrained-path", default="", type=str)
    parser.add_argument("--prop-backend", default="auto", type=str,
                        help="auto | sparse: the block-sparse kernel (its "
                             "plain version on the CPU); the JAX package's "
                             "XLA backends are not ported")
    parser.add_argument("--data-parallel", dest="data_parallel",
                        action="store_true")
    parser.add_argument("--profile-dir", default="", type=str)
    parser.add_argument("--encode-dtype", default="float32", type=str,
                        choices=["float32", "bfloat16"])
    parser.add_argument("--distributed", default=False, action="store_true")
    parser.add_argument("--coordinator-address", default="", type=str)
    parser.add_argument("--num-processes", default=0, type=int)
    parser.add_argument("--process-id", default=-1, type=int)
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) | cuda:N | cpu")

    args = parser.parse_args(argv)
    args.imgSize = args.cropSize
    return args


def check_supported_train(args) -> None:
    """Raise ``NotImplementedError`` naming every set training flag this
    port does not implement. ``--data-parallel`` on one visible card is
    kept: the JAX trainer builds no mesh on one device either."""
    import torch

    bad = []
    for flag, on in (
            ("--distributed", args.distributed),
            ("--data-parallel on more than one card",
             args.data_parallel and torch.cuda.device_count() > 1),
            ("--ckpt-format " + args.ckpt_format, args.ckpt_format != "pth")):
        if on:
            bad.append(flag)
    if bad:
        raise NotImplementedError(
            "not ported to videowalk_tpu_torch yet (see ROADMAP.md): "
            + ", ".join(bad))


def train_args(argv=None):
    """Training args: the JAX package's ``train_args`` flags and their
    post-processing (the fast-test shrink, the prob/method coupling, device
    augmentations implying device superpixels, the node-slot count, the
    auto-named output directory)."""
    parser = argparse.ArgumentParser(description="Video Walk Training")

    parser.add_argument("--data-path", default="/data/kinetics/")
    parser.add_argument("--cache-path", type=str,
                        default="cached_data/kinetics.pt",
                        help="filepath of the cached dataset metadata")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) | cuda:N | cpu")
    parser.add_argument("--clip-len", default=8, type=int, metavar="N")
    parser.add_argument("--clips-per-video", default=5, type=int, metavar="N")
    parser.add_argument("-b", "--batch-size", default=8, type=int)
    parser.add_argument("--epochs", default=25, type=int, metavar="N")
    parser.add_argument("--steps-per-epoch", default=int(1e10), type=int,
                        help="step budget per epoch; if the loader delivers "
                             "fewer batches the epoch warns (or fails under "
                             "--strict-steps)")
    parser.add_argument("--strict-steps", default=False, action="store_true",
                        help="error (instead of warn) when an epoch yields "
                             "fewer batches than --steps-per-epoch")
    parser.add_argument("-j", "--workers", default=10, type=int, metavar="N")
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--momentum", default=0.9, type=float, metavar="M")
    parser.add_argument("--wd", "--weight-decay", default=1e-4, type=float,
                        dest="weight_decay")

    parser.add_argument("--lr-milestones", nargs="+", default=[20, 30, 40],
                        type=int)
    parser.add_argument("--lr-gamma", default=0.3, type=float)
    parser.add_argument("--lr-warmup-epochs", default=0, type=int)
    parser.add_argument("--print-freq", default=10, type=int)
    parser.add_argument("--output-dir", default="auto")
    parser.add_argument("--logs-dir", default="auto")
    parser.add_argument("--resume", default="")
    parser.add_argument("--partial-reload", default="")
    parser.add_argument("--start-epoch", default=0, type=int, metavar="N")

    parser.add_argument("--cache-dataset", dest="cache_dataset",
                        action="store_true")
    parser.add_argument("--data-parallel", dest="data_parallel",
                        action="store_true",
                        help="shard the batch over all local cards")
    parser.add_argument("--fast-test", dest="fast_test", action="store_true")

    parser.add_argument("--name", default="", type=str)
    parser.add_argument("--dropout", default=0, type=float,
                        help="edge dropout rate on A")
    parser.add_argument("--zero-diagonal", action="store_true")
    parser.add_argument("--flip", default=False, action="store_true",
                        help="flip transitions (bug; reference parity)")

    parser.add_argument("--frame-aug", default="", type=str,
                        help="grid or none")
    parser.add_argument("--frame-transforms", default="crop", type=str,
                        help="combine, ex: crop, cj, flip")
    parser.add_argument("--frame-skip", default=8, type=int,
                        help="kinetics: fps | others: frame gap")
    parser.add_argument("--img-size", default=256, type=int)
    parser.add_argument("--patch-size", default=[64, 64, 3], type=int,
                        nargs="+")

    parser.add_argument("--port", default=8095, type=int)
    parser.add_argument("--server", default="localhost", type=str)

    parser.add_argument("--model-type", default="scratch", type=str)
    parser.add_argument("--optim", default="adam", type=str)
    parser.add_argument("--temp", default=0.07, type=float)
    parser.add_argument("--featdrop", default=0.0, type=float)
    parser.add_argument("--restrict", default=-1, type=int)
    parser.add_argument("--head-depth", default=0, type=int)
    parser.add_argument("--visualize", default=False, action="store_true")
    parser.add_argument("--remove-layers", default=[], nargs="*")

    parser.add_argument("--sk-align", default=False, action="store_true")
    parser.add_argument("--sk-targets", default=False, action="store_true")

    parser.add_argument("--sp-method", default="slic", type=str,
                        help="none | slic | fh | random")
    parser.add_argument("--num-sp", default=30, type=int)
    parser.add_argument("--prob", default=1.0, type=float,
                        help="1 for patches; 0 for superpixels")
    parser.add_argument("--compactness", default=200, type=int)

    parser.add_argument("--dilate-superpixels", default=False,
                        action="store_true")
    parser.add_argument("--dilation-kernel-shape", default="L1", type=str,
                        help="L1 | circle | cross")
    parser.add_argument("--dilation-kernel-size", default=51, type=int)

    parser.add_argument("--randomise-superpixels", default=False,
                        action="store_true")
    parser.add_argument("--randomise-superpixels-range", default=10, type=int)

    parser.add_argument("--teacher-student", default=False,
                        action="store_true")
    parser.add_argument("--path-to-pretrained", default="../pretrained.pth",
                        type=str)
    parser.add_argument("--alpha-teacher-student", type=float, default=None)

    # the JAX package's additions to the reference's flags
    parser.add_argument("--prefetch", default=2, type=int,
                        help="copy batches to the card N steps ahead on a "
                             "background thread (0 disables)")
    parser.add_argument("--sp-backend", default="device", type=str,
                        help="device (SLIC on the card) | host (SLIC or "
                             "Felzenszwalb in the loader's threads)")
    parser.add_argument("--max-sp-num", default=-1, type=int,
                        help="static superpixel node slots; -1 = "
                             "num_sp + randomise range / 2 + 8")
    parser.add_argument("--dtype", default="float32", type=str,
                        help="encoder compute dtype: float32 | bfloat16")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--profile-dir", default="", type=str)
    parser.add_argument("--remat", default=False, action="store_true",
                        help="rematerialize encoder blocks in the backward "
                             "pass (less activation memory, more compute)")
    parser.add_argument("--remat-stages", default=None, type=str,
                        help="with --remat: comma list of stages to remat; "
                             "'' or 'all' = every stage; absent = layer1")
    parser.add_argument("--augs-backend", default="host", type=str,
                        help="host (numpy/cv2 in loader threads) | device "
                             "(batched 3-view transform on the card)")
    parser.add_argument("--ckpt-format", default="pth", type=str,
                        help="pth (the reference's dict) | orbax (not "
                             "ported)")
    parser.add_argument("--pretrained-path", default="", type=str)
    parser.add_argument("--debug-nans", default=False, action="store_true",
                        help="torch.autograd.set_detect_anomaly(True): "
                             "errors at the op that made a NaN (slow; the "
                             "reference's own setting). A finite-loss check "
                             "runs at every --print-freq fetch regardless.")
    parser.add_argument("--distributed", default=False, action="store_true")
    parser.add_argument("--coordinator-address", default="", type=str)
    parser.add_argument("--num-processes", default=0, type=int)
    parser.add_argument("--process-id", default=-1, type=int)

    args = parser.parse_args(argv)

    if args.fast_test:
        args.batch_size = 1
        args.workers = 0
        args.data_parallel = False

    if args.prob == 1.0:
        args.sp_method = "none"
    elif args.prob == 0:
        args.frame_aug = "none"

    if args.augs_backend == "device":
        # the host never sees the augmented frames
        args.sp_backend = "device"

    if args.max_sp_num < 0:
        margin = (args.randomise_superpixels_range // 2
                  if args.randomise_superpixels else 0)
        args.max_sp_num = args.num_sp + margin + 8

    if args.output_dir == "auto":
        keys = {
            "dropout": "drop", "clip_len": "len",
            "frame_transforms": "ftrans", "frame_aug": "faug",
            "optim": "optim", "temp": "temp", "featdrop": "fdrop",
            "lr": "lr", "head_depth": "mlp", "sp_method": "sp",
            "num_sp": "nsp", "prob": "p",
        }
        name = "-".join(
            "%s%s" % (keys[k], getattr(args, k)
                      if not isinstance(getattr(args, k), list)
                      else "-".join(str(s) for s in getattr(args, k)))
            for k in keys)
        args.output_dir = "checkpoints/%s_%s/" % (args.name, name)
        dt = datetime.datetime.today()
        args.name = "%s-%s-%s_%s" % (dt.month, dt.day, args.name, name)

    if args.logs_dir == "auto":
        args.logs_dir = os.path.join(args.output_dir, "logs")

    for p in (args.output_dir, args.logs_dir):
        if p:
            os.makedirs(p, exist_ok=True)

    # parsed and dead, as in the reference: say so rather than drop them
    if args.sk_align:
        print("WARNING: --sk-align is parsed but dead (also dead in the "
              "reference); ignored", flush=True)
    if args.lr_warmup_epochs:
        print("WARNING: --lr-warmup-epochs is parsed but dead (also dead in "
              "the reference); ignored", flush=True)
    return args
