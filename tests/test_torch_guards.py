"""Guards of the PyTorch port: it stands apart from JAX and the JAX
package, it never falls back to the CPU behind the caller's back, and its
CUDA kernel matches its plain version on the card (``-m cuda`` tests skip
where there is no card)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import videowalk_tpu_torch
from videowalk_tpu_torch.ops import _build
from videowalk_tpu_torch.ops import prop_sparse as ps
from videowalk_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

PKG = os.path.dirname(videowalk_tpu_torch.__file__)
ROOT = os.path.dirname(PKG)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_import_leaves_jax_out():
    code = ("import importlib, pkgutil, sys, videowalk_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'videowalk_tpu' or m.startswith("
            "'videowalk_tpu.')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_no_source_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|videowalk_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_resolve_device_raises_without_cuda(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device(torch.device("cuda", 0))


def test_train_state_defaults_to_the_card(monkeypatch):
    """``create_train_state`` runs on the card unless asked for the CPU:
    without CUDA the default raises; 'cpu' keeps the model there, and the
    step refuses a batch on another device."""
    from videowalk_tpu_torch.models import CRW, CRWConfig
    from videowalk_tpu_torch.parallel import (create_train_state,
                                              make_optimizer, make_train_step)

    model = CRW(CRWConfig(model_type="scratch_zeropad",
                          remove_layers=("layer3", "layer4")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(model, make_optimizer())
    state = create_train_state(model, make_optimizer(), device="cpu")
    assert state.device == torch.device("cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    batch = torch.zeros((1, 2, 2, 32, 32, 3), device="meta")
    with pytest.raises(ValueError, match="batch on meta"):
        make_train_step()(state, batch)


@pytest.mark.cuda
def test_wrapper_raises_without_its_library(monkeypatch, tmp_path):
    _need_card()
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    f = torch.ones((3, 8, 8, 4), device="cuda") / 2
    lab = torch.zeros((3, 8, 8, 2), device="cuda")
    ctx = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        ps.prop_sparse(f, lab, ctx, 2, n_long=1, topk=3, temperature=0.1,
                       radius=3.0)


@pytest.mark.cuda
def test_rconv_raises_without_its_library(monkeypatch, tmp_path):
    """The reflect-conv wrappers on a CUDA tensor: the kernel or an error,
    never the plain version."""
    from videowalk_tpu_torch.ops import rconv

    _need_card()
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    x = torch.ones((2, 64, 8, 8), device="cuda", dtype=torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.ones((64, 64, 3, 3), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc"):
        rconv.reflect_conv3x3(x, w)
    with pytest.raises(RuntimeError, match="nvcc"):
        rconv.reflect_conv3x3_stats(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dilate_l1", "slic_fused"])
def test_superpixel_wrappers_raise_without_their_library(name, monkeypatch,
                                                         tmp_path):
    """``dilate_l1`` and ``slic_fused`` on a CUDA tensor: the kernel or an
    error, never the plain version; and the model's superpixel path hands
    the error on."""
    from videowalk_tpu_torch.models.crw import superpixel_pool_weights
    from videowalk_tpu_torch.ops.dilation import dilate_l1
    from videowalk_tpu_torch.ops.slic import slic_fused

    _need_card()
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        if name == "dilate_l1":
            dilate_l1(torch.ones((2, 8, 8), device="cuda"), 5)
        else:
            slic_fused(torch.ones((2, 8, 8, 3), device="cuda"), 4)
    if name == "dilate_l1":
        ids = torch.zeros((1, 2, 16, 16), dtype=torch.int64, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            superpixel_pool_weights(ids, 4, (2, 2), dilate=True,
                                    dilation_kernel_size=5)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,radius,topk,n_long", [
    (9, 12, 8, 3.0, 5, 1), (16, 11, 12, 4.0, 7, 2), (13, 10, 256, 5.0, 10, 1),
    (9, 20, 512, 4.0, 10, 1),      # C=512: the 16-key chunk variant
    (9, 20, 384, 4.0, 10, 1)])     # C=384: the 32-key chunk variant
def test_kernel_matches_plain_on_card(H, W, C, radius, topk, n_long):
    """Tolerance 1e-5: f32 dot products summed in another order."""
    _need_card()
    rng = np.random.RandomState(0)
    N, nl = 6, 3
    f = rng.randn(N, H, W, C).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    lab = rng.rand(N, H, W, nl).astype(np.float32)
    ctx = np.arange(n_long + 3, dtype=np.int32) % N
    kw = dict(n_long=n_long, topk=topk, temperature=0.05, radius=radius)
    want = ps.prop_sparse_plain(torch.from_numpy(f), torch.from_numpy(lab),
                                torch.from_numpy(ctx), N - 1, **kw)
    before = ps.prop_sparse.launches
    got = ps.prop_sparse(torch.from_numpy(f).cuda(), torch.from_numpy(lab).cuda(),
                         torch.from_numpy(ctx).cuda(), N - 1, **kw)
    torch.cuda.synchronize()
    assert ps.prop_sparse.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)


@pytest.mark.cuda
def test_kernel_tie_rule_on_card():
    """Quantized features tie many logits exactly; the kernel must keep the
    same (earliest) candidates as the plain version. Labels differ per
    (frame, cell), so another tie choice would change the prediction."""
    _need_card()
    rng = np.random.RandomState(1)
    N, H, W, C, nl = 6, 11, 13, 8, 5
    f = rng.randint(0, 2, (N, H, W, C)).astype(np.float32)
    f[..., 0] = 1.0
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    lab = rng.rand(N, H, W, nl).astype(np.float32)
    ctx = np.array([0, 1, 2, 3, 4], dtype=np.int32)
    kw = dict(n_long=1, topk=6, temperature=0.1, radius=3.0)
    want = ps.prop_sparse_plain(torch.from_numpy(f), torch.from_numpy(lab),
                                torch.from_numpy(ctx), 5, **kw)
    got = ps.prop_sparse(torch.from_numpy(f).cuda(), torch.from_numpy(lab).cuda(),
                         torch.from_numpy(ctx).cuda(), 5, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
