"""The port's CRW feature path against the JAX model: the same weights,
carried by ``state_from_flax`` and loaded with ``strict=True``, the same
seeded input. BN running statistics are randomized first so the BN mapping
is really exercised. Tolerance atol 1e-4: f32 convolutions by different
algorithms on features of order 1."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu.models import CRW as JaxCRW, CRWConfig as JaxConfig

from videowalk_tpu_torch.models import CRW, CRWConfig
from videowalk_tpu_torch.utils.checkpoint import state_from_flax

torch.set_num_threads(1)


def _random_bn_stats(tree, rng):
    return {k: (_random_bn_stats(v, rng) if isinstance(v, dict) else
                (rng.rand(*np.shape(v)).astype(np.float32) + 0.5
                 if k == "var" else
                 rng.randn(*np.shape(v)).astype(np.float32) * 0.1))
            for k, v in tree.items()}


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("model_type", ["scratch", "scratch_zeropad"])
def test_features_match_jax(model_type):
    rng = np.random.RandomState(0)
    x = rng.rand(1, 2, 64, 96, 3).astype(np.float32)
    jm = JaxCRW(JaxConfig(model_type=model_type, remove_layers=("layer4",),
                          head_depth=0))
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        just_feats=True, train=False)
    variables = {"params": _to_numpy(variables["params"]),
                 "batch_stats": _random_bn_stats(
                     _to_numpy(variables["batch_stats"]), rng)}
    # BN scale/bias too, so the affine mapping is not the identity
    params = variables["params"]

    def jitter(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                jitter(v)
            elif k in ("scale", "bias"):
                tree[k] = v + rng.randn(*v.shape).astype(np.float32) * 0.1
    jitter(params)
    q_j, maps_j = jm.apply(variables, jnp.asarray(x), just_feats=True,
                           train=False)

    model = CRW(CRWConfig(model_type=model_type, remove_layers=("layer4",),
                          head_depth=0)).eval()
    model.load_state_dict(state_from_flax(variables), strict=True)
    with torch.no_grad():
        q_t, maps_t = model(torch.from_numpy(x), just_feats=True, train=False)
    assert maps_t.shape == maps_j.shape == (1, 2, 8, 12, 256)
    assert model.spec.map_scale == 8
    np.testing.assert_allclose(maps_t.numpy(), np.asarray(maps_j), atol=1e-4)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-4)


def test_state_dict_names_are_the_reference_names():
    jm = JaxCRW(JaxConfig(model_type="scratch", remove_layers=("layer4",),
                          head_depth=-1))
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 1, 32, 32, 3)), just_feats=True,
                        train=False)
    state = state_from_flax(_to_numpy(dict(variables)))
    assert len(state) == 90
    assert "encoder.model.layer1.0.conv1.weight" in state
    assert "encoder.model.layer2.0.downsample.1.running_var" in state
    model = CRW(CRWConfig(model_type="scratch", remove_layers=("layer4",),
                          head_depth=-1))
    assert set(model.state_dict()) == set(state)


def test_queued_model_types_raise():
    """No model type is queued any more: the reference's eight build with
    the JAX factory's trunk, width and padding; an unknown one raises."""
    from videowalk_tpu.models.encoder import make_encoder as jax_make_encoder

    from videowalk_tpu_torch.models.encoder import make_encoder

    for model_type in ("scratch", "scratch_zeropad", "scratch50",
                       "imagenet18", "imagenet50", "moco50", "timecycle",
                       "uvc"):
        spec = make_encoder(model_type, ("layer4",))
        jspec = jax_make_encoder(model_type, ("layer4",))
        assert (spec.hid_dim, spec.map_scale) == (jspec.hid_dim,
                                                  jspec.map_scale)
        trunk = spec.module.model
        assert (trunk.conv1.reflect_pad > 0) == (
            jspec.module.model.padding_mode == "reflect"), model_type
        assert len(trunk.layer3) == (6 if model_type.endswith("50")
                                     or model_type in ("moco50", "timecycle")
                                     else 2), model_type
    with pytest.raises(ValueError):
        make_encoder("nope")
