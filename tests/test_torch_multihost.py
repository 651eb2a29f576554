"""The port's data parallelism over ``torch.distributed`` on the CPU (gloo
over 127.0.0.1), held to the JAX package's mesh step and to one process
on the global batch.

Two worker processes (``tests/_torch_multihost_worker.py``) form one
cluster, once for the module, and run every multi-rank case; the tests
compare their outputs:

- 3 SGD steps of the layer1-only ``scratch_zeropad`` CRW (edge dropout 0)
  from a JAX init against the JAX ``make_mesh(2)`` step on the same global
  batch (the tolerances of ``tests/test_multihost.py``: gloo sums in
  another order than one process): at temperature 0.1 the losses rtol 1e-4
  and every leaf rtol 1e-3; at 0.05, where the JAX gradient underflows in
  f32, the losses and the BN scale leaves, and every parameter against the
  port's 1-process run;
- the same with edge dropout 0.1 and featdrop 0.1 against the port's own
  1-process run at the same global batch and seeds (loss rtol 1e-4,
  parameters rtol 1e-3, as above);
- f64 BN with a group of 2, moments reduced or given: output, dx, the
  summed weight and bias gradients and the running statistics against one
  process on the concatenated batch (rtol 1e-10);
- f64 Sinkhorn across 2 ranks whose own stop tests would differ: the JAX
  ``sinkhorn_knopp`` of the global batch (rtol 1e-10) and one iteration
  count on both ranks.

The CLIs and the dry run: ``tests/test_torch_multihost_cli.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videowalk_tpu_torch.utils.checkpoint import state_from_flax

from _torch_multihost_worker import (ROOT, bn_case, free_port, global_batch,
                                     run_procs, sinkhorn_inputs, train)

torch.set_num_threads(1)

WORKER = os.path.join(ROOT, "tests", "_torch_multihost_worker.py")


def _jax_model(temperature=0.05):
    from videowalk_tpu.models import CRW, CRWConfig

    return CRW(CRWConfig(model_type="scratch_zeropad",
                         temperature=temperature,
                         remove_layers=("layer2", "layer3", "layer4")))


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The JAX init (as ``state_from_flax`` carries it) and the 2-rank
    run's directory."""
    from videowalk_tpu.parallel import create_train_state, make_optimizer

    out = str(tmp_path_factory.mktemp("cluster"))
    state_j = create_train_state(_jax_model(),
                                 make_optimizer(lr=1e-2, optim="sgd"),
                                 jnp.asarray(global_batch()[:1]),
                                 jax.random.PRNGKey(0))
    variables = {"params": state_j.params,
                 "batch_stats": state_j.batch_stats}
    init = state_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    torch.save(init, os.path.join(out, "init.pt"))
    port = free_port()
    run_procs(lambda r: [sys.executable, WORKER, str(r), "2", str(port),
                         out])
    return out, init, state_j


def _load(out, case):
    return [dict(np.load(os.path.join(out, f"{case}_rank{r}.npz")))
            for r in (0, 1)]


def _sd(res):
    return {k[3:]: v for k, v in res.items() if k.startswith("sd/")}


def _jax_mesh_steps(state_j, temperature):
    """3 SGD steps of the JAX package on ``make_mesh(2)`` over the global
    batch: the losses, the final state (as ``state_from_flax`` names it)
    and the first leaf of its parameter tree (``tests/test_multihost.py``'s
    leaf)."""
    from videowalk_tpu.parallel import (make_mesh, make_optimizer,
                                        make_train_step, replicate,
                                        shard_batch)

    mesh = make_mesh(2)
    state = replicate(state_j, mesh)
    step = make_train_step(_jax_model(temperature),
                           make_optimizer(lr=1e-2, optim="sgd"),
                           donate=False)
    losses = []
    for i in range(3):
        state, metrics = step(state, shard_batch(global_batch(), mesh),
                              jax.random.PRNGKey(42 + i))
        losses.append(float(metrics["loss"]))
    sd = state_from_flax(jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    leaf0 = np.asarray(jax.tree_util.tree_leaves(state.params)[0])
    # num_batches_tracked: torch's own counter, no JAX leaf
    return losses, {k: v.numpy() for k, v in sd.items()
                    if not k.endswith("num_batches_tracked")}, leaf0


def test_two_ranks_match_the_jax_mesh_step(cluster):
    """Both ranks hold the same losses and parameters (bitwise). Against the
    JAX step on ``make_mesh(2)`` over the global batch: the losses rtol
    1e-4, every BN scale leaf rtol 1e-3 (atol 1e-6). Against the port's own
    1-process run on the global batch: every parameter and running
    statistic rtol 1e-3, atol 1e-6.

    Why not every JAX leaf at temperature 0.05: the JAX gradient is not
    exact there (``test_the_jax_walk_gradient_underflows_at_t_0_05``), and
    the two packages' updates part by up to ~10% on one process as on two.
    ``test_two_ranks_match_every_jax_leaf_at_t_0_1`` holds every leaf where
    it is exact."""
    out, _, state_j = cluster
    r0, r1 = _load(out, "jax")
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    for k, v in _sd(r0).items():
        np.testing.assert_array_equal(v, _sd(r1)[k], err_msg=k)
    assert bool(r0["primary"]) and not bool(r1["primary"])

    losses, want, _ = _jax_mesh_steps(state_j, 0.05)
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-4, atol=1e-6)
    got = _sd(r0)
    scales = [k for k in want if ".bn" in k and k.endswith(".weight")]
    assert len(scales) == 5
    for k in scales:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    _, sd = train(cluster[1], global_batch(), 0, 1, None)
    for k, v in sd.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-6,
                                   err_msg=k)


def test_two_ranks_match_every_jax_leaf_at_t_0_1(cluster):
    """At temperature 0.1 (the largest ZeroSoftmax sums ~e^20, where the
    JAX gradient is exact in f32) the 2-rank run equals the JAX
    ``make_mesh(2)`` step: the losses rtol 1e-4, every parameter and
    running statistic rtol 1e-3, atol 1e-6, the first leaf of the JAX
    parameter tree (the stem's BN bias, ``tests/test_multihost.py``'s leaf)
    among them."""
    out, _, state_j = cluster
    r0, r1 = _load(out, "jax_t01")
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    losses, want, leaf0 = _jax_mesh_steps(state_j, 0.1)
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-4, atol=1e-6)
    got = _sd(r0)
    np.testing.assert_array_equal(want["encoder.model.bn1.bias"], leaf0)
    assert want.keys() <= got.keys() and len(want) > 20
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-6,
                                   err_msg=k)


def test_the_jax_walk_gradient_underflows_at_t_0_05():
    """Why the JAX step is not held leaf by leaf at temperature 0.05. At
    near-parallel nodes the ZeroSoftmax logits near 1/T = 20, so each
    row's sum S of (e^x - 1)^2 nears e^40 ~ 2e17. The JAX VJP of
    ``u / (S + eps)`` multiplies the cotangent by (S + eps)^-2 ~ 3e-36
    first; for cotangents below ~4e-3 the product falls under f32's least
    normal (1.2e-38) and XLA:CPU flushes it to zero, so part of the
    denominator's term is lost. The port's autograd keeps it: against
    f64, the port's f32 gradient is within 1e-5 of the largest entry, the
    JAX one is off by more than 1e-4, and scaling the cotangent by 1e3
    (no underflow) brings it back within 1e-5."""
    from videowalk_tpu.core.walk import zero_softmax as jax_zsm

    from videowalk_tpu_torch.core.walk import zero_softmax

    rng = np.random.RandomState(0)
    x = (0.982 + 0.012 * rng.rand(2, 4, 4, 4)).astype(np.float32)
    # cotangents of magnitudes from 1e-4 to 1 (the walk's span many decades)
    ct = (rng.randn(2, 4, 4, 4)
          * 10.0 ** rng.uniform(-4, 0, (2, 4, 4, 4))).astype(np.float32)

    def jax_grad(scale):
        return np.asarray(jax.grad(lambda a: (jax_zsm(a / 0.05) * ct * scale)
                                   .sum())(jnp.asarray(x))) / scale

    def torch_grad(dtype):
        a = torch.from_numpy(x).to(dtype).requires_grad_()
        (zero_softmax(a / 0.05) * torch.from_numpy(ct).to(dtype)).sum() \
            .backward()
        return a.grad.double().numpy()

    want = torch_grad(torch.float64)

    def err(g):
        return np.abs(g - want).max() / np.abs(want).max()

    assert err(torch_grad(torch.float32)) < 1e-5
    assert err(jax_grad(1.0)) > 1e-4
    assert err(jax_grad(1e3)) < 1e-5


def test_two_ranks_draw_the_global_batch(cluster):
    """Edge dropout 0.1 and featdrop 0.1 drawn by ``GlobalBatchGenerator``:
    the 2-rank run equals the port's 1-process run on the global batch at
    the same seeds (loss rtol 1e-4, parameters rtol 1e-3, atol 1e-6). A
    rank drawing at its local shape would draw other masks."""
    out, init, _ = cluster
    r0, _ = _load(out, "draws")
    losses, sd = train(init, global_batch(), 0, 1, None, edgedrop=0.1,
                       featdrop=0.1)
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-4, atol=1e-6)
    for k, v in sd.items():
        np.testing.assert_allclose(_sd(r0)[k], v, rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    # the dropout run left the no-dropout one: the draws took effect
    assert not np.allclose(r0["losses"], _load(out, "jax")[0]["losses"],
                           rtol=1e-3)


@pytest.mark.parametrize("given", [False, True], ids=["reduced", "given"])
def test_batchnorm_group_matches_the_concatenated_batch(cluster, given):
    """f64: the output and dx rows of each rank, the ranks' summed weight
    and bias gradients and the (equal) running statistics against one
    process on the concatenated batch, rtol 1e-10."""
    out, _, _ = cluster
    ranks = _load(out, f"bn{int(given)}")
    one = bn_case(None, 0, 1, given)
    for k in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([r[k] for r in ranks]),
                                   one[k], rtol=1e-10, atol=1e-12, err_msg=k)
    for k in ("dweight", "dbias"):
        np.testing.assert_allclose(ranks[0][k] + ranks[1][k], one[k],
                                   rtol=1e-10, atol=1e-12, err_msg=k)
    for k in ("running_mean", "running_var"):
        for r in ranks:
            np.testing.assert_allclose(r[k], one[k], rtol=1e-10, err_msg=k)


def test_sinkhorn_stops_on_the_global_batch(cluster):
    """Both ranks test the stop rule as often, and their rows equal the JAX
    ``sinkhorn_knopp`` of the global batch (f64, rtol 1e-10); each rank's
    own rows alone would stop after another number of iterations."""
    from videowalk_tpu.core.sinkhorn import sinkhorn_knopp as jax_sk

    from videowalk_tpu_torch.core.sinkhorn import sinkhorn_knopp

    out, _, _ = cluster
    r0, r1 = _load(out, "sinkhorn")
    assert int(r0["n_tests"]) == int(r1["n_tests"])
    A = sinkhorn_inputs()
    with jax.enable_x64(True):
        want = np.asarray(jax_sk(jnp.asarray(A), tol=0.01, max_iter=50))
    np.testing.assert_allclose(np.concatenate([r0["out"], r1["out"]]), want,
                               rtol=1e-10, atol=1e-14)
    alone = [sinkhorn_knopp(torch.from_numpy(A[i:i + 2]), tol=0.01,
                            max_iter=50).numpy() for i in (0, 2)]
    assert not all(np.allclose(a, w, rtol=1e-10, atol=1e-14)
                   for a, w in zip(alone, (want[:2], want[2:])))


def test_global_batch_generator_keeps_the_rank_rows():
    """``core.rng`` draws: a rank's rows of the global draw, for ``rand``
    and ``randint``, at any leading axis; a plain generator is
    ``torch.rand`` / ``torch.randint``."""
    from videowalk_tpu_torch.core import rng

    full_u = torch.rand((6, 3, 2), generator=torch.Generator().manual_seed(5))
    full_i = torch.randint(0, 7, (6,),
                           generator=torch.Generator().manual_seed(6))
    for r in range(3):
        g = rng.GlobalBatchGenerator("cpu", r, 3)
        assert g.device == torch.device("cpu")
        g.manual_seed(5)
        assert torch.equal(rng.rand((2, 3, 2), g), full_u[2 * r:2 * r + 2])
        g.manual_seed(6)
        assert torch.equal(rng.randint(0, 7, (2,), g), full_i[2 * r:2 * r + 2])
    assert torch.equal(rng.rand((6, 3, 2),
                                torch.Generator().manual_seed(5)), full_u)
    with pytest.raises(ValueError):
        rng.GlobalBatchGenerator("cpu", 2, 2)


def test_device_augs_draw_the_global_batch():
    """``train_transform_device`` of a rank's clips with a
    ``GlobalBatchGenerator``: the rank's rows of the global batch's views
    (crops, jitter, flips, the patch grid), bitwise."""
    from videowalk_tpu_torch.core.rng import GlobalBatchGenerator
    from videowalk_tpu_torch.ops.augs_device import train_transform_device

    clips = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (4, 2, 40, 40, 3), dtype=np.uint8))
    kw = dict(img_size=32, patch_size=16, frame_aug="grid+cj+flip",
              frame_transforms="crop+cj+flip")
    full = train_transform_device(clips, torch.Generator().manual_seed(9),
                                  **kw)
    for r in range(2):
        g = GlobalBatchGenerator("cpu", r, 2).manual_seed(9)
        part = train_transform_device(clips[2 * r:2 * r + 2], g, **kw)
        for k in ("grid", "whole", "whole_unnorm"):
            assert torch.equal(part[k], full[k][2 * r:2 * r + 2]), k


def test_data_parallel_spawns_one_worker_per_card(monkeypatch, tmp_path):
    """``--data-parallel`` with 3 visible cards: ``main`` spawns 3 workers,
    each ``main`` as ``--distributed`` rank i of 3 on ``cuda:i`` over
    127.0.0.1; one card takes no spawn."""
    import torch.multiprocessing as mp

    from videowalk_tpu_torch.cli import train as cli
    from videowalk_tpu_torch.utils.arguments import train_args

    monkeypatch.chdir(tmp_path)
    calls, ran = [], []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(mp, "spawn", lambda fn, args, nprocs, join:
                        calls.append((fn, args, nprocs)))
    args = train_args(["--data-parallel", "--output-dir", "o"])
    assert cli.main(args) is None
    (fn, fargs, nprocs), = calls
    assert nprocs == 3 and fargs[0] == 3
    real_main = cli.main
    monkeypatch.setattr(cli, "main", lambda a, d: ran.append(vars(a).copy()))
    for i in range(3):
        fn(i, *fargs)
    assert [(a["distributed"], a["process_id"], a["num_processes"],
             a["device"]) for a in ran] == [
        (True, i, 3, f"cuda:{i}") for i in range(3)]
    assert all(a["coordinator_address"].startswith("127.0.0.1:")
               for a in ran)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        real_main(train_args(["--data-parallel", "--output-dir", "o"]))
    assert len(calls) == 1


def test_eval_data_parallel_takes_every_visible_card(monkeypatch):
    """``cli.test``'s ``--data-parallel``: every visible card where the host
    has two or more and the process is not a ``--distributed`` rank; none
    (one device, as the JAX eval without a mesh) on one card or the CPU."""
    from videowalk_tpu_torch.cli.test import data_parallel_devices
    from videowalk_tpu_torch.utils.arguments import test_args

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cuda = torch.device("cuda", 0)
    args = test_args(["--data-parallel"])
    assert data_parallel_devices(args, cuda) == [
        torch.device("cuda", i) for i in range(3)]
    assert data_parallel_devices(args, torch.device("cpu")) is None
    assert data_parallel_devices(test_args([]), cuda) is None
    assert data_parallel_devices(
        test_args(["--data-parallel", "--distributed"]), cuda) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert data_parallel_devices(args, cuda) is None
