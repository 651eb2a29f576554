"""The port's teacher-student CRW (``models/teacher_student.py``) against
the JAX package's ``videowalk_tpu/models/teacher_student.py``, and the
frozen teacher under the train step (``create_train_state(...,
frozen_prefixes=("teacher.",))``).

The JAX model's variables (head biases and the teacher's BN running
statistics set away from their init, so that the eval-mode teacher is not
an identity) are carried by ``state_from_flax`` and loaded with
``strict=True``. Tolerances as ``tests/test_torch_train_step.py``: f32 q
atol 1e-4, loss rtol 1e-4, diagnostics rtol 1e-4 / atol 1e-5, running
statistics atol 1e-4 of their scale; f64 gradients atol 3e-5 of each
parameter's largest entry. JAX's keyed edge dropout is replaced by given
masks in the test that turns it on."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu.core import walk as jw
from videowalk_tpu.models import CRWConfig as JaxConfig
from videowalk_tpu.models.teacher_student import (
    CRWTeacherStudent as JaxTS, soft_cross_entropy as jax_soft_xent)

from videowalk_tpu_torch.models import (CRWConfig, CRWTeacherStudent,
                                        soft_cross_entropy)
from videowalk_tpu_torch.parallel import (create_train_state, make_optimizer,
                                          make_train_step)
from videowalk_tpu_torch.utils.checkpoint import state_from_flax

torch.set_num_threads(1)

TEMP, ALPHA, RATE = 0.05, 0.3, 0.1


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _variables(jm, x, dtype=np.float32):
    """Seeded JAX variables with nonzero head biases and teacher running
    statistics away from (0, 1)."""
    v = _np(dict(jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a,
                                           train=False))(jnp.asarray(x))))
    rng = np.random.RandomState(5)
    for head in ("student_head", "teacher_head"):
        b = v["params"][head]["fc0"]["bias"]
        v["params"][head]["fc0"]["bias"] = 0.1 * rng.randn(*b.shape)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            v["batch_stats"]["teacher_encoder"])[0]:
        node = v["batch_stats"]["teacher_encoder"]
        for k in path[:-1]:
            node = node[k.key]
        name = path[-1].key
        node[name] = (0.1 * rng.randn(*leaf.shape) if name == "mean"
                      else 0.5 + rng.rand(*leaf.shape))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), v)


def _clips(h=32, T=4, seed=1):
    return np.random.RandomState(seed).randn(2, T, 4, h, h, 3).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_f32():
    """The f32 JAX model (``scratch``, the flagship's reflect-padded trunk)
    and its variables, built once."""
    cfg = dict(model_type="scratch", temperature=TEMP, edgedrop_rate=RATE)
    jm = JaxTS(JaxConfig(**cfg), alpha=ALPHA)
    return jm, _variables(jm, _clips()), cfg


def _torch_model(variables, cfg, **kw):
    model = CRWTeacherStudent(CRWConfig(**{**cfg, **kw}), alpha=ALPHA)
    model.load_state_dict(state_from_flax(variables), strict=True)
    return model


def test_soft_cross_entropy_matches_jax():
    rng = np.random.RandomState(0)
    inputs = rng.rand(12, 9).astype(np.float32)
    target = rng.rand(12, 9).astype(np.float32)
    target /= target.sum(-1, keepdims=True)
    got = soft_cross_entropy(torch.from_numpy(inputs), torch.from_numpy(target))
    np.testing.assert_allclose(
        float(got), float(jax_soft_xent(jnp.asarray(inputs),
                                        jnp.asarray(target))), rtol=1e-6)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_forward_matches_jax(jax_f32, rate, monkeypatch):
    """The train forward: q, loss, every diagnostic, the student's new
    running statistics, and the teacher's left as they were. With edge
    dropout on, both sides drop the same given masks from the student's
    walk (the JAX model's two keyed draws are replaced by them in order)."""
    jm, variables, cfg = jax_f32
    if rate == 0.0:
        jm = JaxTS(JaxConfig(**{**cfg, "edgedrop_rate": 0.0}), alpha=ALPHA)
    x = _clips()
    rng = np.random.RandomState(7)
    masks = [rng.rand(2, 3, 4, 4) < RATE for _ in range(2)]
    drawn = iter(masks)
    monkeypatch.setattr(jw, "edge_dropout", lambda key, A, r: jnp.where(
        jnp.moveaxis(next(drawn), 1, 0), jnp.asarray(-1e20, A.dtype), A))
    (q_j, loss_j, diags_j), upd = jax.jit(lambda a: jm.apply(
        variables, a, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(3)}))(jnp.asarray(x))

    model = _torch_model(variables, cfg, edgedrop_rate=rate)
    teacher0 = {k: v.clone() for k, v in model.teacher.state_dict().items()}
    with torch.no_grad():
        q, loss, diags = model(
            torch.from_numpy(x), train=True,
            walk_masks=[torch.from_numpy(m) for m in masks] if rate else None)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=1e-4)
    assert set(diags) == set(diags_j) >= {"crw_loss", "ts_loss",
                                          "xent cyc r2", "acc cyc r2"}
    for k, v in diags_j.items():
        np.testing.assert_allclose(float(diags[k]), float(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    state = model.state_dict()
    for k, v in state_from_flax({"batch_stats": _np(upd["batch_stats"])}
                                ).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(
                state[k].numpy(), v.numpy(), rtol=0,
                atol=1e-4 * max(1.0, float(v.abs().max())), err_msg=k)
    for k, v in model.teacher.state_dict().items():
        assert torch.equal(v, teacher0[k]), k


def test_student_grads_match_jax_in_float64():
    """Every student parameter's gradient of the train-mode loss, the port
    in f64 against ``jax.grad`` under x64 (rate 0, 16 px patches, layer4
    removed: XLA's f64 convolutions on the CPU take ~30 s with it; the
    trunk's own gradients are held with layer4 by
    ``test_torch_train_step.py::test_crw_grads_match_jax_in_float64``,
    whose tolerance and grounds hold here). The teacher gets no gradient:
    ``None`` in the port, zeros in JAX."""
    x = _clips(h=16).astype(np.float64)
    cfg = dict(model_type="scratch", temperature=TEMP,
               remove_layers=("layer4",))
    variables = _variables(JaxTS(JaxConfig(**cfg), alpha=ALPHA),
                           x.astype(np.float32), np.float64)
    with jax.enable_x64(True):
        jm = JaxTS(JaxConfig(dtype=jnp.float64, **cfg), alpha=ALPHA)

        def loss_fn(params):
            (_, loss, _), _ = jm.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(x), train=True, mutable=["batch_stats"])
            return loss

        grads_j = _np(jax.jit(jax.grad(loss_fn))(variables["params"]))
    assert all(not np.any(g) for g in jax.tree_util.tree_leaves(
        {k: v for k, v in grads_j.items() if k.startswith("teacher")}))
    grads = state_from_flax({"params": grads_j})
    model = _torch_model(variables, cfg, dtype=torch.float64).double()
    q, loss, _ = model(torch.from_numpy(x), train=True)
    assert q.dtype == torch.float64
    loss.backward()
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    student = [k for k in params if not k.startswith("teacher.")]
    assert "selfsim_fc.0.bias" in student
    for k in params:
        if k.startswith("teacher."):
            assert params[k].grad is None, k
    for k in student:
        g = grads[k].double().numpy()
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=0,
                                   atol=3e-5 * np.abs(g).max(), err_msg=k)


def test_short_clips_give_q_and_zero_losses(jax_f32):
    jm, variables, cfg = jax_f32
    x = _clips(T=2)
    (q_j, loss_j, diags_j), _ = jax.jit(lambda a: jm.apply(
        variables, a, train=True, mutable=["batch_stats"]))(jnp.asarray(x))
    model = _torch_model(variables, cfg)
    with torch.no_grad():
        q, loss, diags = model(torch.from_numpy(x), train=True,
                               generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=1e-4)
    assert float(loss) == float(loss_j) == 0.0
    assert set(diags) == set(diags_j) == {"crw_loss", "ts_loss"}
    assert all(float(v) == 0.0 for v in diags.values())


def test_refusals():
    cfg = dict(model_type="scratch_zeropad",
               remove_layers=("layer3", "layer4"))
    for alpha in (-0.1, 1.5):
        with pytest.raises(ValueError, match="alpha"):
            CRWTeacherStudent(CRWConfig(**cfg), alpha=alpha)
    for flag in ("sk_targets", "zero_diagonal"):
        with pytest.raises(ValueError, match="not supported"):
            CRWTeacherStudent(CRWConfig(**cfg, **{flag: True}))
    model = CRWTeacherStudent(CRWConfig(**cfg))
    with pytest.raises(ValueError, match="patch grids"):
        model(torch.zeros(1, 4, 32, 32, 3))


def test_teacher_stays_bitwise_frozen_under_adam():
    """3 Adam steps with edge dropout 0.1 through ``make_train_step``:
    every teacher parameter and buffer (``num_batches_tracked`` included)
    is bitwise what it was, no teacher parameter is in the optimizer, and
    the student has moved."""
    torch.manual_seed(0)
    model = CRWTeacherStudent(CRWConfig(
        model_type="scratch", temperature=TEMP, edgedrop_rate=RATE,
        remove_layers=("layer4",)))
    state = create_train_state(model, make_optimizer(lr=3e-4), device="cpu",
                               frozen_prefixes=("teacher.",))
    trained = {id(p) for g in state.optimizer.param_groups
               for p in g["params"]}
    for name, p in model.named_parameters():
        frozen = name.startswith("teacher.")
        assert (id(p) in trained) != frozen and p.requires_grad != frozen
    teacher0 = {k: v.clone() for k, v in model.teacher.state_dict().items()}
    student0 = model.encoder.model.conv1.weight.detach().clone()
    step = make_train_step()
    x = torch.from_numpy(_clips())
    gen = torch.Generator().manual_seed(2)
    metrics = [step(state, x, gen) for _ in range(3)]
    assert all(torch.isfinite(m["loss"]) for m in metrics)
    for k, v in model.teacher.state_dict().items():
        assert torch.equal(v, teacher0[k]), k
    assert int(model.teacher.encoder.model.bn1.num_batches_tracked) == 0
    assert int(model.encoder.model.bn1.num_batches_tracked) == 3
    assert not torch.equal(model.encoder.model.conv1.weight, student0)
