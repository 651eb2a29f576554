"""One rank of the port's 2-process CPU cluster for
tests/test_torch_multihost.py (gloo over 127.0.0.1).

    python _torch_multihost_worker.py <rank> <world> <port> <dir>

Joins the process group through ``parallel.multihost`` and runs each case,
writing ``<dir>/<case>_rank<r>.npz`` for the test to hold against the JAX
package's mesh step and against one process on the global batch:

- ``jax``: 3 SGD steps of the layer1-only ``scratch_zeropad`` CRW from the
  init in ``<dir>/init.pt`` (a JAX init carried by ``state_from_flax``),
  edge dropout 0, on this rank's rows of the global batch;
- ``jax_t01``: the same at temperature 0.1, where the JAX step's
  gradient is exact in f32 (at 0.05 it is not: ``test_torch_multihost.py``);
- ``draws``: the same with edge dropout 0.1 and featdrop 0.1 from a
  ``GlobalBatchGenerator`` seeded alike on both ranks;
- ``bn``: one f64 train-mode ``BatchNorm`` with the group attached, its
  moments reduced from x or given as ``moments=``;
- ``sinkhorn``: f64 ``sinkhorn_knopp`` with the group's global stop test.

``free_port``, ``worker_env`` and ``run_procs`` start such clusters for
the tests (of this script, or of the CLIs).
"""

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

GLOBAL_B = 4


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    """A free TCP port of 127.0.0.1 (for a process group's address)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_procs(cmd_for_rank, world=2, timeout=300) -> list[str]:
    """Start ``world`` processes (output to temporary files, so that no
    pipe fills while another rank waits in a collective), wait for all;
    a failed or hung one fails the caller, and none outlives it. Returns
    each one's output."""
    import subprocess
    import tempfile

    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = [subprocess.Popen(cmd_for_rank(r), cwd=ROOT, env=worker_env(),
                              stdout=log, stderr=subprocess.STDOUT,
                              text=True) for r, log in enumerate(logs)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for r, (code, out) in enumerate(zip(codes, outs)):
        assert code == 0, f"rank {r} exited {code}:\n{out[-4000:]}"
    return outs


def global_batch():
    return np.random.RandomState(0).randn(
        GLOBAL_B, 3, 4, 32, 32, 3).astype(np.float32)


def crw_model(edgedrop=0.0, featdrop=0.0, dtype=torch.float32,
              temperature=0.05):
    from videowalk_tpu_torch.models import CRW, CRWConfig

    return CRW(CRWConfig(model_type="scratch_zeropad",
                         temperature=temperature,
                         remove_layers=("layer2", "layer3", "layer4"),
                         edgedrop_rate=edgedrop, featdrop_rate=featdrop,
                         dtype=dtype))


def train(init, batch, rank, world, group, edgedrop=0.0, featdrop=0.0,
          steps=3, dtype=torch.float32, temperature=0.05):
    """``steps`` SGD steps (lr 1e-2, momentum 0.9) from ``init`` on
    ``batch`` (this rank's rows) in ``dtype`` at the walk's
    ``temperature``; returns the losses and the final state_dict.
    ``group`` None: one process on the whole batch."""
    from videowalk_tpu_torch.core.rng import GlobalBatchGenerator
    from videowalk_tpu_torch.parallel import (create_train_state,
                                              make_optimizer, make_train_step)

    model = crw_model(edgedrop, featdrop, dtype, temperature)
    model.load_state_dict(init, strict=True)
    model.to(dtype)
    state = create_train_state(model, make_optimizer(lr=1e-2, optim="sgd"),
                               device="cpu", group=group)
    step = make_train_step()
    x = torch.from_numpy(batch).to(dtype)
    losses = []
    for i in range(steps):
        gen = (GlobalBatchGenerator("cpu", rank, world) if group is not None
               else torch.Generator())
        gen.manual_seed(42 + i)
        losses.append(float(step(state, x, gen)["loss"]))
    return np.asarray(losses), {k: v.numpy().copy()
                                for k, v in model.state_dict().items()}


def bn_case(group, rank, world, given):
    """One f64 BatchNorm over this rank's rows of x (8, 5, 6, 6): output,
    dx, dweight, dbias of sum(y * g), the new running statistics."""
    from videowalk_tpu_torch.models.resnet import BatchNorm

    rng = np.random.RandomState(1)
    x = rng.randn(8, 5, 6, 6) * 3 + 1
    g = rng.randn(8, 5, 6, 6)
    b = 8 // world
    rows = slice(rank * b, (rank + 1) * b)
    m = BatchNorm(5, torch.float64).double()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(1 + 0.1 * rng.randn(5)))
        m.bias.copy_(torch.from_numpy(0.1 * rng.randn(5)))
    m.group = group
    xt = torch.from_numpy(x[rows]).requires_grad_()
    moments = ((xt.sum(dim=(0, 2, 3)), (xt * xt).sum(dim=(0, 2, 3)))
               if given else None)
    y = m(xt, train=True, moments=moments)
    (y * torch.from_numpy(g[rows])).sum().backward()
    return dict(y=y.detach().numpy(), dx=xt.grad.numpy(),
                dweight=m.weight.grad.numpy(), dbias=m.bias.grad.numpy(),
                running_mean=m.running_mean.numpy(),
                running_var=m.running_var.numpy())


def sinkhorn_inputs():
    """(4, 6, 6) f64: matrices 0-1 (rank 0's) nearly doubly stochastic,
    2-3 (rank 1's) far from it, so that each rank's own stop test would stop
    after another number of iterations than the global one."""
    rng = np.random.RandomState(2)
    near = 1 + 1e-3 * rng.rand(2, 6, 6)
    far = np.exp(3 * rng.randn(2, 6, 6))
    return np.concatenate([near, far])


def sinkhorn_case(group, rank, world):
    from videowalk_tpu_torch.core import sinkhorn

    A = sinkhorn_inputs()
    b = A.shape[0] // world
    tests = []
    inner = sinkhorn._colsum_std

    def counted(a, g):
        v = inner(a, g)
        tests.append(v)
        return v

    sinkhorn._colsum_std = counted
    try:
        out = sinkhorn.sinkhorn_knopp(
            torch.from_numpy(A[rank * b:(rank + 1) * b]), tol=0.01,
            max_iter=50, group=group)
    finally:
        sinkhorn._colsum_std = inner
    return dict(out=out.numpy(), n_tests=np.asarray(len(tests)))


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    import torch.distributed as dist

    from videowalk_tpu_torch.parallel import multihost

    n = multihost.initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}", num_processes=world,
        process_id=rank, device="cpu")
    assert n == world == multihost.world() and multihost.rank() == rank
    assert dist.get_backend() == "gloo"
    group = dist.group.WORLD
    try:
        init = torch.load(os.path.join(out, "init.pt"))
        local = global_batch()[rank * GLOBAL_B // world:
                               (rank + 1) * GLOBAL_B // world]
        for case, kw in (("jax", {}), ("jax_t01", dict(temperature=0.1)),
                         ("draws", dict(edgedrop=0.1, featdrop=0.1))):
            losses, sd = train(init, local, rank, world, group, **kw)
            np.savez(os.path.join(out, f"{case}_rank{rank}.npz"),
                     losses=losses, primary=multihost.is_primary(),
                     **{"sd/" + k: v for k, v in sd.items()})
        for given in (False, True):
            np.savez(os.path.join(out, f"bn{int(given)}_rank{rank}.npz"),
                     **bn_case(group, rank, world, given))
        np.savez(os.path.join(out, f"sinkhorn_rank{rank}.npz"),
                 **sinkhorn_case(group, rank, world))
    finally:
        multihost.shutdown()
    print("WORKER_OK", rank, flush=True)


if __name__ == "__main__":
    main()
