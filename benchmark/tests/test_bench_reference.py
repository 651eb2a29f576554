"""The benchmark's plain reference held to the port's plain CPU routes at a
tiny size: the trunk in train and eval mode, patch and superpixel nodes
with the walk loss, the first Adam step, the L1 dilation, SLIC and the
label propagation. The reference imports nothing of the port; these
tests import both."""

import numpy as np
import pytest
import torch

from harness import common, inputs
from reference import crw as ref
from reference import propagation as ref_prop
from reference import slic as ref_slic
from videowalk_tpu_torch.models import CRW, CRWConfig

SEED = 2 ** 33 + 17


def seeded_model(model_type="scratch", **kw):
    cfg = CRWConfig(model_type=model_type, temperature=0.05, **kw)
    model = CRW(cfg)
    weights = common.seeded_weights(model.state_dict(), SEED, "cpu")
    model.load_state_dict(weights)
    return model, weights


@pytest.mark.parametrize("train", [True, False])
def test_trunk(train):
    model, weights = seeded_model()
    x = torch.randn(4, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    want = model.encoder.model(x, train)
    got = ref.trunk(weights, x, train=train)
    assert got.shape == want.shape == (4, 512, 8, 8)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_trunk_without_layer4():
    model, weights = seeded_model(remove_layers=("layer4",))
    x = torch.randn(2, 3, 48, 80, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(ref.trunk(weights, x, train=False),
                               model.encoder.model(x, False),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("train", [True, False])
def test_bottleneck_trunk(train):
    """``scratch50``'s ResNet-50: the weights' ``conv3`` picks the
    Bottleneck."""
    model, weights = seeded_model("scratch50")
    assert "encoder.model.layer1.0.conv3.weight" in weights
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    want = model.encoder.model(x, train)
    got = ref.trunk(weights, x, train=train)
    assert got.shape == want.shape == (2, 2048, 8, 8)
    # eval-mode BN on the seeded running statistics leaves 16 blocks
    # unnormalized: the maps grow to ~1e3, and f32 rounding with them
    scale = float(want.abs().max()) if not train else 1.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_batch_norm_without_a_group_is_the_plain_formula():
    """Train-mode BN outside ``global_batch``: the batch's own moments,
    bitwise the formula the reference states."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(6, 5, 7, 3, generator=gen)
    sd = {"bn.weight": torch.randn(5, generator=gen),
          "bn.bias": torch.randn(5, generator=gen)}
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + ref.BN_EPS) * sd["bn.weight"]
    want = ((x - mean[:, None, None]) * mul[:, None, None]
            + sd["bn.bias"][:, None, None])
    assert torch.equal(ref.batch_norm(x, sd, "bn", True), want)


def walk_masks(q_shape, seed):
    B, _, T, N = q_shape
    gen = torch.Generator().manual_seed(seed)
    return ref.dropout_masks((B, T - 1, N, N), 0.1, gen, "cpu")


def test_patch_loss():
    model, weights = seeded_model(edgedrop_rate=0.1)
    unit = inputs.moving_textures(torch.Generator().manual_seed(3), 2, 4, 64,
                                  8, "cpu")
    x = inputs.patch_grid(inputs.normalize(unit), 32)
    _, want, _ = model(x, train=True,
                       generator=torch.Generator().manual_seed(7))
    q = ref.patch_nodes(weights, x)
    got = ref.walk_loss(q, 0.05, *walk_masks(q.shape, 7))
    assert q.shape == (2, 128, 4, 9)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)


def test_superpixel_loss():
    model, weights = seeded_model(edgedrop_rate=0.1, max_sp_num=12,
                                  dilate_superpixels=True,
                                  dilation_kernel_size=7)
    unit = inputs.moving_textures(torch.Generator().manual_seed(4), 2, 4, 64,
                                  8, "cpu")
    labels = ref_slic.slic(unit, 9, 30.0)
    frames = inputs.normalize(unit)
    _, want, _ = model(frames, sp_mask=labels.to(torch.int32), train=True,
                       generator=torch.Generator().manual_seed(8))
    q = ref.superpixel_nodes(weights, frames, labels, n_slots=12,
                             dilation_kernel_size=7)
    got = ref.walk_loss(q, 0.05, *walk_masks(q.shape, 8))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("model_type", ["scratch", "scratch50"])
def test_first_adam_step(model_type):
    from videowalk_tpu_torch.parallel import (create_train_state,
                                              make_optimizer, make_train_step)

    # bn_fuse "stats": the BN-input chain's f32 plain version moves these
    # gradients by ~2e-3 at this size (it agrees to 5e-6 in f64)
    model, weights = seeded_model(model_type, edgedrop_rate=0.1,
                                  bn_fuse="stats")
    unit = inputs.moving_textures(torch.Generator().manual_seed(5), 2, 4, 64,
                                  8, "cpu")
    x = inputs.patch_grid(inputs.normalize(unit), 32)
    state = create_train_state(model, make_optimizer(lr=3e-4), device="cpu")
    metrics = make_train_step()(state, x,
                                torch.Generator().manual_seed(9))

    def loss_fn(sd, i, batch):
        q = ref.patch_nodes(sd, batch)
        return ref.walk_loss(q, 0.05, *walk_masks(q.shape, 9))

    losses, grad1, after = ref.adam_steps(weights, [x], loss_fn, lr=3e-4)
    assert losses[0] == pytest.approx(float(metrics["loss"]), rel=1e-5)
    params = dict(state.model.named_parameters())
    assert set(after) == set(params)
    for k, p in params.items():
        g = state.optimizer.state[p]["exp_avg"] / 0.1
        torch.testing.assert_close(grad1[k], g, rtol=1e-3, atol=1e-5)


def test_dilation():
    from videowalk_tpu_torch.ops.dilation import dilate_l1_plain

    gen = torch.Generator().manual_seed(6)
    x = (torch.rand((5, 40, 50), generator=gen) < 0.01).to(torch.float32)
    for k in (5, 13, 55):
        assert torch.equal(ref.dilate_l1(x, k // 2), dilate_l1_plain(x, k))


def test_slic():
    from videowalk_tpu_torch.ops.slic_device import slic

    unit = inputs.moving_textures(torch.Generator().manual_seed(7), 2, 2, 96,
                                  12, "cpu")
    got = ref_slic.slic(unit, 16, 40.0)
    want = slic(unit, 16, 40.0)
    assert float((got == want.to(torch.int64)).double().mean()) >= 0.99


def test_propagation():
    from videowalk_tpu_torch.eval.propagation import (context_index_bank,
                                                      propagate_labels)

    gen = torch.Generator().manual_seed(8)
    n_ctx, N = 3, 9
    feats = torch.randn((N, 16, 6, 7), generator=gen)
    feats = feats / torch.linalg.vector_norm(feats, dim=1, keepdim=True)
    feats[:n_ctx] = feats[n_ctx]
    labels0 = torch.softmax(torch.randn((N, 6, 7, 3), generator=gen), -1)
    labels0[:n_ctx] = labels0[n_ctx]
    want = propagate_labels(
        feats, labels0, context_index_bank(n_ctx, [0], N - n_ctx),
        n_context=n_ctx, n_long=1, topk=5, temperature=0.05, radius=3.0)
    got = ref_prop.propagate(feats, labels0, n_context=n_ctx, long_mem=[0],
                             topk=5, temperature=0.05, radius=3.0, block=10)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert np.array_equal(ref_prop.context_rows(n_ctx, [0, 2], N - n_ctx),
                          context_index_bank(n_ctx, [0, 2], N - n_ctx))
