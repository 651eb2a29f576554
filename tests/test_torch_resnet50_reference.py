"""The port's ResNet-50 CRW (``--model-type scratch50``) held to the
benchmark's plain reference (``benchmark/reference/crw.py``), which
imports nothing of the port, on seeded weights at a tiny size on the CPU:

- two Adam steps of the default train step (``bn_fuse="auto"``: a
  Bottleneck's routed 3x3 emits bn2's moments; the 1x1s and projections
  on plain convs): both losses, the gradient of step 1 and the
  parameters' change after step 2;
- the evaluator's encoder (``cli/test.py::encode_video``, f32, eval-mode
  BN) with layer4 removed, C = 1024.

The benchmark's files are loaded by path under names of their own, so
that no module of this suite is shadowed. No JAX here."""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.parallel import (create_train_state, make_optimizer,
                                          make_train_step)

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
SEED = 2 ** 33 + 26
TEMP, RATE, LR = 0.05, 0.1, 3e-4


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(BENCH, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _load("_bench_reference_crw", "reference/crw.py")
common = _load("_bench_harness_common", "harness/common.py")
inputs = _load("_bench_harness_inputs", "harness/inputs.py")


def _seeded(**cfg):
    torch.manual_seed(0)
    model = CRW(CRWConfig(model_type="scratch50", temperature=TEMP,
                          edgedrop_rate=RATE, **cfg))
    weights = common.seeded_weights(model.state_dict(), SEED, "cpu")
    model.load_state_dict(weights)
    return model, weights


def _masks(q_shape, seed: int):
    B, _, T, N = q_shape
    return ref.dropout_masks((B, T - 1, N, N), RATE,
                             torch.Generator().manual_seed(seed), "cpu")


@pytest.fixture(scope="module")
def two_steps():
    """Both sides' two Adam steps on one 3-frame clip of 2x2 patches of
    32 px (12 trunk images: layer1's 3x3s at 8x8 route, the rest not)."""
    model, weights = _seeded()
    assert model.cfg.bn_fuse == "auto" and model.encoder.model.hid_dim == 2048
    batches = [inputs.patch_grid(inputs.normalize(inputs.moving_textures(
        torch.Generator().manual_seed(10 + i), 1, 3, 48, 8, "cpu")), 32)
        for i in range(2)]
    state = create_train_state(model, make_optimizer(lr=LR), device="cpu")
    step = make_train_step()
    losses, grad1 = [], None
    for i, x in enumerate(batches):
        metrics = step(state, x, torch.Generator().manual_seed(20 + i))
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad1 = {k: state.optimizer.state[p]["exp_avg"] / 0.1
                     for k, p in state.model.named_parameters()}

    def loss_fn(sd, i, x):
        q = ref.patch_nodes(sd, x)
        return ref.walk_loss(q, TEMP, *_masks(q.shape, 20 + i))

    ref_losses, ref_grad1, after = ref.adam_steps(weights, batches, loss_fn,
                                                  lr=LR)
    params = {k: p.detach() for k, p in state.model.named_parameters()}
    return types.SimpleNamespace(
        losses=losses, grad1=grad1, params=params, weights=weights,
        ref_losses=ref_losses, ref_grad1=ref_grad1, ref_after=after)


def test_two_adam_steps_losses(two_steps):
    s = two_steps
    # step 1: the same f32 forward up to the order of its sums (reads 0);
    # step 2 starts from step 1's update, which carries the sign noise of
    # the change below into the loss (reads 4.5e-6)
    assert s.losses[0] == pytest.approx(s.ref_losses[0], rel=1e-6)
    assert s.losses[1] == pytest.approx(s.ref_losses[1], rel=5e-5)
    assert abs(s.losses[1] - s.losses[0]) > 1e-3      # step 1 moved it


def test_step_one_gradient(two_steps):
    """Every leaf of step 1's gradient (Adam's first moment over 1 − β1),
    within 3e-5 of the leaf's largest element: the worst leaf reads
    2.9e-6, f32 sums over 12 images in another order."""
    s = two_steps
    assert set(s.grad1) == set(s.ref_grad1)
    for k, g in s.grad1.items():
        want = s.ref_grad1[k]
        scale = float(want.abs().max())
        assert scale > 0, k
        assert float((g - want).abs().max()) <= 3e-5 * scale, k


def test_change_after_step_two(two_steps):
    """The parameters' change after two steps, over the reference's: Adam
    moves each weight by ~lr·sign(g) at first, and the weights whose
    gradient lies within f32 rounding of zero take either sign, which
    reads 2.1% of the whole change (5.6% on the worst leaf). An unchanged
    state reads 1, a doubled learning rate 1; 6% is three times the
    reading."""
    s = two_steps
    num = den = 0.0
    for k, p in s.params.items():
        d_prog = p - s.weights[k]
        d_ref = s.ref_after[k] - s.weights[k]
        num += float(((d_prog - d_ref) ** 2).sum())
        den += float((d_ref ** 2).sum())
    assert den > 0
    assert (num / den) ** 0.5 <= 0.06


def test_eval_encoder_without_layer4():
    """``encode_video`` at the eval configuration's depth (layer4 removed,
    C = 1024) on uint8 frames, against the reference's eval-mode trunk on
    the same frames normalized as the benchmark's check does. Eval-mode BN
    on the seeded running statistics leaves 13 blocks unnormalized: the
    maps grow to ~250, so the maps are held to f32 rounding at their
    scale, and the unit features, which the propagation reads, by the
    largest distance between a cell's vectors (the eval cell's
    ``feat_gap``: reads 1.9e-6 here, the TF32 control ~1e-3)."""
    from videowalk_tpu_torch.cli.test import encode_video

    model, weights = _seeded(remove_layers=("layer4",))
    model.eval()
    assert model.encoder.model.hid_dim == 1024
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, size=(3, 40, 72, 3), dtype=np.uint8)
    got = encode_video(model, frames, batch_size=2, l2=False)
    x = ref.normalize_frames(torch.from_numpy(frames).to(torch.float32)
                             / 255.0)
    with torch.no_grad():
        want = ref.trunk(weights, x.permute(0, 3, 1, 2), train=False)
    assert got.shape == want.shape == (3, 1024, 5, 9)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)

    def unit(f):
        return f / torch.linalg.vector_norm(f, dim=1, keepdim=True)

    gap = float(torch.linalg.vector_norm(unit(got) - unit(want), dim=1).max())
    assert gap <= 1e-5
