"""The port's multi-GPU entry points on the CPU (gloo over 127.0.0.1):
``cli.train --distributed`` on 2 processes (rank 0 alone writes the
``.pth`` files; ``--resume`` on both), ``cli.test --distributed`` (its
mask PNGs byte-identical to one process's) and ``parallel/dryrun.py`` at
world 2. The data-parallel semantics against the JAX package and one
process: ``tests/test_torch_multihost.py``."""

import os
import subprocess
import sys

import torch

from _synth import make_crw_checkpoint, make_davis_tree, make_kinetics_tree
from _torch_multihost_worker import ROOT, free_port, run_procs, worker_env

torch.set_num_threads(1)


def _train_argv(data, out, *extra):
    return ["--device", "cpu", "--data-path", data, "--frame-aug", "grid",
            "--clip-len", "4", "--temp", "0.05", "--dropout", "0.1",
            "--model-type", "scratch_zeropad", "--remove-layers", "layer2",
            "layer3", "layer4", "--img-size", "64", "--patch-size", "16",
            "16", "3", "--lr", "0.0003", "--steps-per-epoch", "2",
            "--batch-size", "2", "--workers", "2", "--print-freq", "1",
            "--prob", "1.0", "--cache-path", os.path.join(out, "cache.pt"),
            "--output-dir", os.path.join(out, "ck"),
            "--logs-dir", os.path.join(out, "logs"), *extra]


def test_distributed_train_cli_rank0_writes_and_resumes(tmp_path):
    """``cli.train --distributed`` on 2 processes (global batch 2, one clip
    a rank), each with its own output directory: rank 0 alone writes the
    ``.pth`` files; both ranks ``--resume`` rank 0's checkpoint for epoch 1
    and report the same global losses."""
    root = str(tmp_path / "kin")
    make_kinetics_tree(root)
    data = os.path.join(root, "val_256")
    port = free_port()

    def cmd(epochs, resume=()):
        return lambda r: [
            sys.executable, "-m", "videowalk_tpu_torch.cli.train",
            "--distributed", "--coordinator-address", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(r),
            *_train_argv(data, str(tmp_path / f"o{r}"), "--epochs",
                         str(epochs), *resume)]

    outs = run_procs(cmd(1))
    ck0, ck1 = (str(tmp_path / f"o{r}" / "ck") for r in (0, 1))
    assert sorted(os.listdir(ck0)) == ["checkpoint.pth", "model_0.pth"]
    assert not os.path.isdir(ck1) or not os.listdir(ck1)
    for out in outs:
        assert "Training time" in out, out[-3000:]
    losses = [[line.split("loss: ")[1].split()[0] for line in o.splitlines()
               if "loss: " in line] for o in outs]
    assert losses[0] and losses[0] == losses[1]

    port = free_port()
    outs = run_procs(cmd(2, ("--resume", os.path.join(ck0,
                                                       "checkpoint.pth"))))
    for out in outs:
        assert "Resumed from" in out and "start_epoch=1" in out, out[-3000:]
    assert "model_1.pth" in os.listdir(ck0)
    assert not os.path.isdir(ck1) or not os.listdir(ck1)


def test_distributed_eval_cli_matches_one_process(tmp_path):
    """``cli.test --distributed`` on 2 processes over a 2-video synthetic
    DAVIS tree (process r takes videos r, r + 2, ...) into one save path:
    every mask PNG byte-identical to one process's, named by the global
    video index."""
    from videowalk_tpu_torch.cli.test import main
    from videowalk_tpu_torch.eval.make_davis_vallist import make_list
    from videowalk_tpu_torch.utils.arguments import test_args

    davis = make_davis_tree(str(tmp_path / "DAVIS"))
    ckpt = make_crw_checkpoint(str(tmp_path / "ckpt.pth"))
    vallist = str(tmp_path / "davis_vallist.txt")
    with open(vallist, "w") as f:
        f.write("\n".join(make_list(davis)) + "\n")

    def argv(save):
        return ["--device", "cpu", "--filelist", vallist, "--resume", ckpt,
                "--save-path", save, "--model-type", "scratch",
                "--cropSize", "-1", "--radius", "6", "--videoLen", "3",
                "--topk", "5", "--temperature", "0.05"]

    port = free_port()
    shared = str(tmp_path / "dist")
    outs = run_procs(lambda r: [
        sys.executable, "-m", "videowalk_tpu_torch.cli.test", *argv(shared),
        "--distributed", "--coordinator-address", f"127.0.0.1:{port}",
        "--num-processes", "2", "--process-id", str(r)])
    assert "Vid 0" in outs[0] and "Vid 1" not in outs[0]
    assert "Vid 1" in outs[1] and "Vid 0" not in outs[1]
    single = str(tmp_path / "single")
    main(test_args(argv(single)))
    masks = sorted(f for f in os.listdir(single) if f.endswith("_mask.png"))
    assert {m.split("_")[0] for m in masks} == {"0", "1"}
    assert masks == sorted(f for f in os.listdir(shared)
                           if f.endswith("_mask.png"))
    for m in masks:
        with open(os.path.join(single, m), "rb") as f1, \
                open(os.path.join(shared, m), "rb") as f2:
            assert f1.read() == f2.read(), m


def test_dryrun_multichip_on_the_cpu():
    """``parallel/dryrun.py`` at world 2 on the CPU (gloo): one step each
    of patch CRW, superpixel CRW and teacher-student, finite and equal on
    both ranks; the split encode and the banded propagation over
    ``[cpu] * 2`` as one device's (its own checks)."""
    out = subprocess.run(
        [sys.executable, "-m", "videowalk_tpu_torch.parallel.dryrun",
         "--world", "2", "--device", "cpu"], cwd=ROOT, env=worker_env(),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "dryrun_multichip(2): OK" in out.stdout
