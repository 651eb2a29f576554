"""The port's trainer (``python -m videowalk_tpu_torch.cli.train``,
``utils/arguments.py::train_args``) on the CPU against the JAX package's
(``videowalk_tpu/cli/train.py``, ``utils/arguments.py``): the flag surface,
the refusal of unported flags, and ``main`` on the synthetic Kinetics tree
(``scratch_zeropad`` without layer4, 64 px frames, 4-frame clips, batch 2): its
checkpoint read by the JAX package and by the port's eval CLI, the
device-SLIC superpixel path, the patch/superpixel draw order and the LR
schedule against JAX's, teacher-student from a port-written teacher,
``--resume`` of a port-written and of a JAX-written ``.pth``, the NaN abort
at the fetch and ``--strict-steps``.

Tolerance: features atol 1e-5 (one f32 evaluation by each package at the
same weights; unit vectors); everything else exact."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu.parallel.train_step import multistep_lr
from videowalk_tpu.utils.arguments import train_args as jax_train_args

from videowalk_tpu_torch.cli import train as cli
from videowalk_tpu_torch.utils.arguments import (check_supported_train,
                                                 train_args)
from videowalk_tpu_torch.utils.checkpoint import load_checkpoint

from _synth import make_kinetics_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# train.sh's flags (its config of record), with the device augmentations
TRAIN_SH = ["--frame-aug", "grid", "--dropout", "0.1", "--clip-len", "4",
            "--temp", "0.05", "--model-type", "scratch", "--batch-size", "6",
            "--lr", "0.0003", "--prob", "0.7", "--sp-method", "slic",
            "--num-sp", "36", "--compactness", "50", "--dilate-superpixels",
            "--dilation-kernel-shape", "L1", "--dilation-kernel-size", "55",
            "--epochs", "20", "--sp-backend", "device", "--dtype", "bfloat16",
            "--data-parallel", "--augs-backend", "device"]


@pytest.fixture(scope="module")
def kinetics(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kinetics"))
    make_kinetics_tree(root)
    return os.path.join(root, "val_256")


def _argv(data, out, *extra, steps=2, batch=2, patch=16):
    return ["--device", "cpu", "--data-path", data, "--frame-aug", "grid",
            "--clip-len", "4", "--temp", "0.05", "--dropout", "0.1",
            "--model-type", "scratch_zeropad", "--remove-layers", "layer4",
            "--img-size", "64",
            "--patch-size", str(patch), str(patch), "3", "--lr", "0.0003",
            "--epochs", "1", "--steps-per-epoch", str(steps),
            "--batch-size", str(batch), "--workers", "2", "--print-freq", "1",
            "--cache-path", os.path.join(out, "cache.pt"),
            "--output-dir", os.path.join(out, "ck"),
            "--logs-dir", os.path.join(out, "logs"), *extra]


@pytest.fixture(scope="module")
def trained(kinetics, tmp_path_factory):
    """``python -m videowalk_tpu_torch.cli.train --device cpu``: 2 patch
    steps of epoch 0; its output directory."""
    out = str(tmp_path_factory.mktemp("run"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-m", "videowalk_tpu_torch.cli.train",
         *_argv(kinetics, out, "--prob", "1.0")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "Epoch: [0]  [1/2]" in res.stdout
    return os.path.join(out, "ck")


def _record(monkeypatch, fake_loss=None):
    """Wrap the trainer's step: record each update's LR, path and
    ``n_active``; with ``fake_loss(i)`` skip the model and return it."""
    rec = types.SimpleNamespace(lr=[], paths=[], n_active=[])
    real_step = cli.make_train_step()

    def make_train_step():
        def step(state, batch, gen, sp_mask=None):
            rec.lr.append(state.optimizer.param_groups[0]["lr"])
            rec.paths.append("sp" if sp_mask is not None else "patch")
            if fake_loss is None:
                return real_step(state, batch, gen, sp_mask=sp_mask)
            state.step += 1
            return {"loss": torch.tensor(fake_loss(len(rec.paths) - 1))}
        return step

    real_slic = cli.slic_fused

    def slic_fused(x, n, c, **kw):
        rec.n_active.append(None if kw.get("n_active") is None
                            else kw["n_active"].tolist())
        return real_slic(x, n, c, **kw)

    monkeypatch.setattr(cli, "make_train_step", make_train_step)
    monkeypatch.setattr(cli, "slic_fused", slic_fused)
    return rec


@pytest.mark.parametrize("argv", [
    TRAIN_SH,
    ["--prob", "0", "--randomise-superpixels", "--num-sp", "20"],
    ["--fast-test", "--teacher-student", "--lr-milestones", "3", "5",
     "--augs-backend", "device", "--sp-backend", "host"],
    ["--sk-align", "--lr-warmup-epochs", "2", "--name", "x"],
], ids=["train_sh", "superpixels", "fast_ts", "dead_flags"])
def test_train_args_match_the_jax_namespace(argv, tmp_path, monkeypatch):
    """The same argv gives the JAX namespace, except ``--device`` (the
    card, not the TPU) and the auto name's date, which both carry."""
    monkeypatch.chdir(tmp_path)
    port, ref = vars(train_args(argv)), vars(jax_train_args(argv))
    assert port.pop("device") == "cuda" and ref.pop("device") == "tpu"
    assert port == ref
    if argv is TRAIN_SH:
        assert port["max_sp_num"] == 44 and port["sp_backend"] == "device"
        assert port["output_dir"].startswith("checkpoints/")


# refused until the host side of the trainer was ported; now accepted
NOW_PORTED = ("--sp-backend host", "--visualize", "--profile-dir",
              "image-folder")


@pytest.mark.parametrize("flag,argv", [
    ("--distributed", ["--distributed"]),
    ("--sp-backend host", ["--prob", "0.5", "--sp-backend", "host"]),
    ("--visualize", ["--visualize"]),
    ("--profile-dir", ["--profile-dir", "trace"]),
    ("--ckpt-format orbax", ["--ckpt-format", "orbax"]),
    ("image-folder", "image_folder"),
    ("--data-parallel on more than one card", ["--data-parallel"]),
])
def test_check_supported_train_refuses_unported_flags(flag, argv, tmp_path,
                                                      monkeypatch):
    """The flags still unported raise, naming themselves. Those the port
    has since ported (``NOW_PORTED``: host superpixels, ``--visualize``,
    ``--profile-dir``, an image folder) pass, and an image folder is read
    by the port's ``ImageFolder``."""
    import cv2

    from videowalk_tpu_torch.data.image_folder import ImageFolder

    monkeypatch.chdir(tmp_path)
    base = ["--output-dir", str(tmp_path / "o")]
    if argv == "image_folder":
        (tmp_path / "imgs" / "cls").mkdir(parents=True)
        cv2.imwrite(str(tmp_path / "imgs" / "cls" / "0.jpg"),
                    np.zeros((8, 8, 3), np.uint8))
        argv = ["--data-path", str(tmp_path / "imgs")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    if flag in NOW_PORTED:
        args = train_args(base + argv)
        check_supported_train(args)
        if flag == "image-folder":
            assert isinstance(cli.make_dataset(args, None), ImageFolder)
        return
    with pytest.raises(NotImplementedError, match=flag):
        check_supported_train(train_args(base + argv))
    if flag.startswith("--data-parallel"):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        check_supported_train(train_args(base + argv))   # one card: kept
    check_supported_train(train_args(base + ["--prob", "0.5"]))


@pytest.mark.parametrize("argv", [
    ["--remat"], ["--remat-stages", "layer1"],
    ["--remat", "--remat-stages", "all"]] + [
    ["--model-type", t] for t in ("scratch50", "imagenet18", "imagenet50",
                                  "moco50", "timecycle", "uvc")])
def test_check_supported_train_accepts_ported_flags(argv, tmp_path,
                                                    monkeypatch):
    """The encoder variants and remat pass the check; beside an unported
    flag, that flag alone is named."""
    monkeypatch.chdir(tmp_path)
    base = ["--output-dir", str(tmp_path / "o")]
    check_supported_train(train_args(base + argv))
    with pytest.raises(NotImplementedError) as err:
        check_supported_train(train_args(base + argv + ["--distributed"]))
    assert str(err.value).endswith("(see ROADMAP.md): --distributed")


def test_checkpoint_reads_in_the_jax_package_and_the_eval_cli(
        trained, tmp_path, monkeypatch):
    """``checkpoint.pth`` of the CLI run: the JAX package's
    ``load_checkpoint`` + ``torch_to_flax_state`` fill every leaf of its
    CRW and give the port's features; its ``lr_scheduler`` carries the
    step the JAX trainer resumes at; the port's eval CLI loads its
    encoder."""
    from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig
    from videowalk_tpu.utils.checkpoint import (load_checkpoint as jax_load,
                                                torch_to_flax_state)

    from videowalk_tpu_torch.models import CRW, CRWConfig

    path = os.path.join(trained, "checkpoint.pth")
    assert os.path.isfile(os.path.join(trained, "model_0.pth"))
    ckpt = jax_load(path)
    assert ckpt["epoch"] == 0 and ckpt["args"]["batch_size"] == 2
    sched = ckpt["lr_scheduler"]
    assert sched["step"] == 2 and sched["gamma"] == 0.3
    assert sched["milestones"] == [10 * m for m in (20, 30, 40)]
    assert len(ckpt["optimizer"]["state"]) > 0

    x = np.random.RandomState(0).randn(1, 3, 4, 16, 16, 3).astype(np.float32)
    jm = JaxCRW(JaxConfig(model_type="scratch_zeropad", temperature=0.05,
                              remove_layers=("layer4",)))
    init = jax.jit(lambda a: jm.init(jax.random.PRNGKey(1), a, train=False))(
        jnp.asarray(x))
    loaded = torch_to_flax_state(ckpt["model"], init, verbose=False)
    leaves = zip(jax.tree_util.tree_leaves(loaded),
                 jax.tree_util.tree_leaves(init))
    assert all(not np.array_equal(a, b) for a, b in leaves)
    q_j, _ = jax.jit(lambda v, a: jm.apply(v, a, just_feats=True,
                                           train=False))(loaded, jnp.asarray(x))
    model = CRW(CRWConfig(model_type="scratch_zeropad", temperature=0.05,
                          remove_layers=("layer4",)))
    model.load_state_dict(load_checkpoint(path)["model"])
    with torch.no_grad():
        q, _ = model(torch.from_numpy(x), just_feats=True, train=False)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=1e-5)

    from videowalk_tpu.eval.make_davis_vallist import make_list

    from videowalk_tpu_torch.cli import test as eval_cli
    from videowalk_tpu_torch.utils.arguments import test_args
    from _synth import make_davis_tree

    davis = str(tmp_path / "DAVIS")
    make_davis_tree(davis, vids=("video0",), hw=64, frames=4)
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(make_list(davis)) + "\n")
    loads = []
    real = eval_cli.partial_load

    def partial_load(state, model, **kw):
        loads.append(real(state, model, **kw))
        return loads[-1]

    monkeypatch.setattr(eval_cli, "partial_load", partial_load)
    stats = eval_cli.main(test_args([
        "--device", "cpu", "--filelist", str(lst), "--resume", path,
        "--model-type", "scratch_zeropad", "--cropSize", "-1",
        "--videoLen", "2", "--topk", "3", "--radius", "4",
        "--save-path", str(tmp_path / "res")]))
    assert [s["targets"] for s in stats] == [4]
    enc = [k for k in model.state_dict() if k.startswith("encoder.")
           and "layer4" not in k]
    assert set(enc) <= set(loads[0])


def test_prob_zero_takes_the_device_slic_path(kinetics, tmp_path,
                                              monkeypatch):
    """``--prob 0``: every step segments the unnormalized view with
    ``slic_fused`` (its plain version on the CPU) and steps on whole frames
    with ``sp_mask``; 17 node slots for ``--num-sp 9``."""
    rec = _record(monkeypatch)
    args = train_args(_argv(kinetics, str(tmp_path), "--prob", "0",
                            "--num-sp", "9", "--compactness", "30",
                            "--dilate-superpixels",
                            "--dilation-kernel-size", "7", steps=1))
    assert args.max_sp_num == 17 and args.frame_aug == "none"
    state = cli.main(args)
    assert rec.paths == ["sp"] and rec.n_active == [None]
    assert state.step == 1 and state.model.cfg.max_sp_num == 17


@pytest.fixture(scope="module")
def mixed(kinetics, tmp_path_factory):
    """``--prob 0.5 --randomise-superpixels`` over 2 epochs of 4 steps
    (batch 1, 32 px patches; 4 videos of one clip each: 4 batches an
    epoch), milestones at 1 and 3 epochs (updates 4 and 12), gamma 0.5."""
    mp = pytest.MonkeyPatch()
    try:
        rec = _record(mp)
        out = str(tmp_path_factory.mktemp("mixed"))
        args = train_args(_argv(
            kinetics, out, "--prob", "0.5", "--randomise-superpixels",
            "--randomise-superpixels-range", "4", "--num-sp", "9",
            "--compactness", "30", "--epochs", "2", "--lr-milestones", "1",
            "3", "--lr-gamma", "0.5", "--clips-per-video", "1",
            "--seed", "3", steps=4, batch=1, patch=32))
        state = cli.main(args)
    finally:
        mp.undo()
    return args, state, rec


def test_paths_follow_the_jax_draw_order(mixed):
    """A numpy replay of the JAX trainer's draws (``RandomState(seed +
    epoch)``: the Bernoulli path, on a superpixel step the ``n_active``
    randint, then the checkpoint coin) gives the run's paths and
    ``n_active``; both paths occur."""
    args, state, rec = mixed
    paths, n_active = [], []
    for epoch in range(2):
        rng = np.random.RandomState(args.seed + epoch)
        for _ in range(4):
            grid = bool(rng.choice([True, False], p=[0.5, 0.5]))
            paths.append("patch" if grid else "sp")
            if not grid:
                n_active.append(rng.randint(7, 11, (4,)).tolist())
            rng.random_sample()
    assert rec.paths == paths and set(paths) == {"patch", "sp"}
    assert rec.n_active == n_active
    assert state.step == 8 and args.max_sp_num == 9 + 2 + 8


def test_lr_follows_jax_multistep_lr(mixed):
    """The LR of update k is the JAX trainer's ``multistep_lr(lr,
    [len(loader) * m], gamma)(k)``."""
    args, state, rec = mixed
    milestones = [4 * m for m in args.lr_milestones]    # 4 batches an epoch
    sched = multistep_lr(args.lr, milestones, args.lr_gamma)
    want = [float(sched(k)) for k in range(8)]
    np.testing.assert_allclose(rec.lr, want, rtol=1e-6)
    assert rec.lr[3] == pytest.approx(3e-4) and rec.lr[4] == pytest.approx(
        1.5e-4)


def test_teacher_student_leaves_the_teacher_bitwise_unchanged(
        trained, kinetics, tmp_path, monkeypatch):
    """``--teacher-student`` from the CLI's own ``model_0.pth``: the
    teacher equals the file bit for bit after 2 steps, the student moved;
    a missing teacher file raises."""
    rec = _record(monkeypatch)
    teacher = os.path.join(trained, "model_0.pth")
    argv = _argv(kinetics, str(tmp_path), "--teacher-student",
                 "--alpha-teacher-student", "0.5")
    state = cli.main(train_args(argv + ["--path-to-pretrained", teacher]))
    assert rec.paths == ["patch", "patch"] and state.step == 2
    saved = load_checkpoint(teacher)["model"]
    got = state.model.teacher.state_dict()
    assert set(saved) <= set(got)       # the teacher's head also has a bias
    for k, v in saved.items():
        assert torch.equal(got[k], v), k
    student = state.model.state_dict()
    assert not torch.equal(student["encoder.model.conv1.weight"],
                           saved["encoder.model.conv1.weight"])
    with pytest.raises(FileNotFoundError, match="path-to-pretrained"):
        cli.main(train_args(argv + ["--path-to-pretrained",
                                    str(tmp_path / "none.pth")]))
    with pytest.raises(ValueError, match="probabilistic sp"):
        cli.main(train_args(argv + ["--path-to-pretrained", teacher,
                                    "--prob", "0.5"]))


def test_resume_continues_at_the_saved_step_and_epoch(trained, kinetics,
                                                      tmp_path):
    """``--resume`` of the CLI's ``checkpoint.pth`` (epoch 0, step 2) with
    ``--epochs 2``: epoch 1 only, from step 2, Adam's moments restored."""
    args = train_args(_argv(kinetics, str(tmp_path), "--epochs", "2",
                            "--resume", os.path.join(trained,
                                                     "checkpoint.pth")))
    state = cli.main(args)
    assert args.start_epoch == 1 and state.step == 4
    assert state.scheduler.last_epoch == 4
    adam_steps = {int(s["step"]) for s in state.optimizer.state.values()}
    assert adam_steps == {4}
    assert load_checkpoint(os.path.join(args.output_dir, "checkpoint.pth")
                           )["lr_scheduler"]["step"] == 4


def test_the_jax_trainer_resumes_a_port_written_checkpoint(trained, kinetics,
                                                         tmp_path, capsys):
    """The JAX package's ``cli.train.main --resume`` of the port's
    ``checkpoint.pth`` (epoch 0, step 2) with ``--epochs 1``: it takes the
    weights, skips the torch optimizer's state with its printed line, and
    stands at step 2 and epoch 1 (no epoch left to train)."""
    from videowalk_tpu.cli.train import main as jax_main

    path = os.path.join(trained, "checkpoint.pth")
    args = jax_train_args(_argv(kinetics, str(tmp_path), "--resume", path,
                                "--prefetch", "0")[2:])
    state = jax_main(args)
    assert "optimizer state not restored" in capsys.readouterr().out
    assert int(state.step) == 2 and args.start_epoch == 1
    conv = np.asarray(state.params["encoder"]["model"]["conv1"]["kernel"])
    want = load_checkpoint(path)["model"]["encoder.model.conv1.weight"]
    np.testing.assert_array_equal(conv.transpose(3, 2, 0, 1), want.numpy())


def test_resume_of_a_jax_written_checkpoint(kinetics, tmp_path, capsys):
    """A ``.pth`` of the JAX package's ``save_checkpoint`` (its weights,
    optax's Adam state, ``lr_scheduler={step, milestones, gamma}``, epoch
    2): the weights load, optax's state is skipped with a line, the run
    continues at step 7 of epoch 3."""
    import optax

    from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig
    from videowalk_tpu.utils.checkpoint import save_checkpoint as jax_save

    jm = JaxCRW(JaxConfig(model_type="scratch_zeropad", temperature=0.05,
                              remove_layers=("layer4",)))
    var = jax.jit(lambda a: jm.init(jax.random.PRNGKey(2), a, train=False))(
        jnp.zeros((1, 2, 4, 16, 16, 3)))
    path = str(tmp_path / "jax.pth")
    jax_save(path, var, optimizer_state=optax.adam(1e-3).init(var["params"]),
             lr_scheduler_state={"step": 7, "milestones": [100], "gamma": 0.3},
             epoch=2, args={})
    args = train_args(_argv(kinetics, str(tmp_path), "--epochs", "4",
                            "--resume", path, steps=1))
    state = cli.main(args)
    assert "optimizer state not restored" in capsys.readouterr().out
    assert args.start_epoch == 3 and state.step == 8
    conv = np.asarray(var["params"]["encoder"]["model"]["conv1"]["kernel"])
    got = state.model.state_dict()["encoder.model.conv1.weight"].numpy()
    delta = np.abs(got - conv.transpose(3, 2, 0, 1)).max()
    assert 0 < delta < 1e-2      # the JAX weights, moved by one Adam step


def test_a_planted_nan_aborts_at_the_fetch(kinetics, tmp_path, monkeypatch):
    """A NaN loss from step 1 on, ``--print-freq 2``: steps 0-2 run and the
    fetch of step 2 raises; no checkpoint of the epoch is written."""
    rec = _record(monkeypatch, fake_loss=lambda i: 1.0 if i == 0 else
                  float("nan"))
    argv = _argv(kinetics, str(tmp_path), steps=6) + ["--print-freq", "2"]
    with pytest.raises(FloatingPointError, match="epoch 0 step 2"):
        cli.main(train_args(argv))
    assert len(rec.paths) == 3
    assert not os.path.exists(os.path.join(str(tmp_path), "ck",
                                           "model_0.pth"))


def test_strict_steps_raises_on_a_short_loader(kinetics, tmp_path,
                                               monkeypatch, capsys):
    """The loader holds 10 batches: ``--steps-per-epoch 12`` warns, and
    raises under ``--strict-steps``."""
    _record(monkeypatch, fake_loss=lambda i: 1.0)
    argv = _argv(kinetics, str(tmp_path), steps=12)
    state = cli.main(train_args(argv))
    assert state.step == 10
    assert "delivered 10 batches but --steps-per-epoch requested 12" in \
        capsys.readouterr().out
    with pytest.raises(RuntimeError, match="delivered 10 batches"):
        cli.main(train_args(argv + ["--strict-steps"]))


def test_resumed_run_ends_bitwise_where_the_uninterrupted_run_ends(
        kinetics, tmp_path):
    """Two epochs of 2 steps with ``--dropout 0.1`` and the device
    augmentations, uninterrupted, against one epoch, its ``checkpoint.pth``
    and ``--resume`` for the second: the edge-dropout and aug streams are
    keyed by the global step, and the sampler's pass by the epoch, so both
    end in the same model and optimizer state, bit for bit."""
    def run(out, *extra):
        return cli.main(train_args(_argv(
            kinetics, str(tmp_path / out), "--prob", "1.0",
            "--augs-backend", "device", "--seed", "5", *extra)))

    whole = run("whole", "--epochs", "2")
    run("first", "--epochs", "1")
    resumed = run("resumed", "--epochs", "2", "--resume",
                  str(tmp_path / "first" / "ck" / "checkpoint.pth"))
    assert whole.step == resumed.step == 4
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb["state"][i][k])), (i, k)
