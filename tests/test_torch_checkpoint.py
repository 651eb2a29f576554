"""The port's checkpoint writers (``utils/checkpoint.py``): the
reference-format ``.pth`` of ``save_checkpoint`` against the JAX package's
reader (``videowalk_tpu/utils/checkpoint.py::torch_to_flax_state``), and
the full-state resume of ``save_train_state`` / ``load_train_state``.

Tolerances: features atol 1e-5 (one f32 evaluation by each package at the
same weights; unit vectors); resume bitwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig
from videowalk_tpu.models.teacher_student import CRWTeacherStudent as JaxTS
from videowalk_tpu.utils.checkpoint import torch_to_flax_state

from videowalk_tpu_torch.models import CRW, CRWConfig, CRWTeacherStudent
from videowalk_tpu_torch.parallel import (create_train_state, make_optimizer,
                                          make_train_step)
from videowalk_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  load_train_state,
                                                  save_checkpoint,
                                                  save_train_state)

torch.set_num_threads(1)

SMALL = dict(model_type="scratch", temperature=0.05, edgedrop_rate=0.1,
             remove_layers=("layer3", "layer4"))


def _clips(T=4, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        2, T, 4, 32, 32, 3).astype(np.float32))


def _trained_state(model, frozen=(), steps=1, seed=0):
    """``model`` after ``steps`` Adam steps on the CPU (running statistics,
    moments and the schedule away from their init)."""
    state = create_train_state(model, make_optimizer(lr=1e-3,
                                                     milestones=(2,)),
                               device="cpu", frozen_prefixes=frozen)
    step, gen = make_train_step(), torch.Generator().manual_seed(seed)
    for _ in range(steps):
        step(state, _clips(), gen)
    return state


def test_pth_loads_into_the_jax_package_with_equal_features(tmp_path):
    """A port CRW after one training step, written by ``save_checkpoint``,
    read by the JAX package's ``torch_to_flax_state`` into its own CRW:
    every leaf loads, and the eval features (``just_feats``) agree."""
    torch.manual_seed(0)
    cfg = dict(model_type="scratch", temperature=0.05, head_bias=True)
    state = _trained_state(CRW(CRWConfig(**cfg)))
    path = tmp_path / "model_1.pth"
    save_checkpoint(str(path), state.model, state.optimizer, state.scheduler,
                    epoch=1, args={"lr": 1e-3})
    ckpt = load_checkpoint(str(path))
    assert set(ckpt) == {"model", "optimizer", "lr_scheduler", "epoch",
                         "args"}
    assert ckpt["epoch"] == 1 and ckpt["args"] == {"lr": 1e-3}
    assert ckpt["optimizer"]["state"] and "milestones" in ckpt["lr_scheduler"]
    assert all(v.device.type == "cpu" for v in ckpt["model"].values())
    assert set(ckpt["model"]) == set(state.model.state_dict())

    x = _clips(T=3, seed=2)
    jm = JaxCRW(JaxConfig(**cfg))
    init = jax.jit(lambda a: jm.init(jax.random.PRNGKey(1), a, train=False))(
        jnp.asarray(x.numpy()))
    loaded = torch_to_flax_state(ckpt["model"], init, verbose=False)
    n_leaves = len(jax.tree_util.tree_leaves(init))
    assert sum(not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(init))
               ) == n_leaves
    q_j, maps_j = jax.jit(lambda v, a: jm.apply(v, a, just_feats=True,
                                                train=False))(
        loaded, jnp.asarray(x.numpy()))
    with torch.no_grad():
        q, maps = state.model(x, just_feats=True, train=False)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=1e-5)
    np.testing.assert_allclose(maps.numpy(), np.asarray(maps_j), rtol=1e-4,
                               atol=1e-4 * float(np.abs(maps_j).max()))


def test_teacher_student_pth_keeps_the_reference_names(tmp_path, capsys):
    """The teacher-student ``.pth`` holds ``encoder.*``, ``selfsim_fc.*``,
    ``teacher.encoder.*`` and ``teacher.selfsim_fc.*``, and every one of
    its tensors fills a leaf of the JAX ``CRWTeacherStudent``."""
    torch.manual_seed(0)
    model = CRWTeacherStudent(CRWConfig(**SMALL))
    path = tmp_path / "checkpoint.pth"
    save_checkpoint(str(path), model)
    ckpt = load_checkpoint(str(path))
    keys = set(ckpt["model"])
    assert {"encoder.model.conv1.weight", "selfsim_fc.0.bias",
            "teacher.encoder.model.layer1.0.conv1.weight",
            "teacher.encoder.model.bn1.running_var",
            "teacher.selfsim_fc.0.weight"} <= keys
    assert ckpt["optimizer"] is None and ckpt["epoch"] == 0
    jcfg = {k: v for k, v in SMALL.items() if k != "edgedrop_rate"}
    jm = JaxTS(JaxConfig(**jcfg))
    init = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a,
                                            train=False),
                          jnp.zeros((1, 3, 2, 32, 32, 3)))
    capsys.readouterr()
    torch_to_flax_state(ckpt["model"], init, verbose=True)
    assert "Skipped keys:  []" in capsys.readouterr().out
    used = [k for k in keys if not k.endswith("num_batches_tracked")]
    assert len(used) == len(jax.tree_util.tree_leaves(init))


@pytest.mark.parametrize("kind", ["crw", "teacher_student"])
def test_resume_continues_bitwise(tmp_path, kind):
    """k=2 steps, ``save_train_state``, then 2 more steps in a fresh state
    loaded from the file, against 4 uninterrupted steps: the parameters,
    buffers, Adam moments, the schedule's LR and the losses are bitwise
    equal (edge dropout 0.1 and featdrop 0.1 drawn from the saved
    generator; the LR milestone at 2 falls in the resumed half)."""
    cfg = CRWConfig(**SMALL, featdrop_rate=0.1)
    build = ((lambda: CRW(cfg)) if kind == "crw"
             else (lambda: CRWTeacherStudent(cfg)))
    frozen = ("teacher.",) if kind == "teacher_student" else ()
    step, x = make_train_step(), _clips()

    def fresh():
        torch.manual_seed(0)
        return create_train_state(build(), make_optimizer(
            lr=1e-3, milestones=(2,)), device="cpu", frozen_prefixes=frozen)

    whole, gen = fresh(), torch.Generator().manual_seed(7)
    losses = [float(step(whole, x, gen)["loss"]) for _ in range(4)]

    first, gen = fresh(), torch.Generator().manual_seed(7)
    for _ in range(2):
        step(first, x, gen)
    path = tmp_path / "state.pt"
    save_train_state(str(path), first, gen)
    del first
    torch.manual_seed(123)                      # another init, overwritten
    resumed = create_train_state(build(), make_optimizer(
        lr=1e-3, milestones=(2,)), device="cpu", frozen_prefixes=frozen)
    gen = torch.Generator().manual_seed(99)     # another stream, overwritten
    load_train_state(str(path), resumed, gen)
    assert resumed.step == 2
    resumed_losses = [float(step(resumed, x, gen)["loss"]) for _ in range(2)]

    assert resumed_losses == losses[2:]
    assert resumed.step == whole.step == 4
    for (k, a), b in zip(whole.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for pa, pb in zip(whole.optimizer.param_groups[0]["params"],
                      resumed.optimizer.param_groups[0]["params"]):
        sa, sb = whole.optimizer.state[pa], resumed.optimizer.state[pb]
        for m in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[m], sb[m]), m
    assert whole.scheduler.get_last_lr() == resumed.scheduler.get_last_lr()
