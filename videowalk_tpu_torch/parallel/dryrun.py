"""Multi-process dry run of the port's data-parallel paths (the counterpart
of ``__graft_entry__.py::dryrun_multichip``).

    python -m videowalk_tpu_torch.parallel.dryrun --world 2 [--device cuda]
        [--backend gloo|nccl]

``world`` processes (``torch.multiprocessing.spawn``, joined at a free
port of 127.0.0.1) each take one step of patch CRW, superpixel CRW (SLIC
on the device) and teacher-student on their row block of a seeded global
batch of one clip a rank, as the JAX dry run does on its mesh; every loss
must be finite and every rank must report the same. Then, in this
process, the eval's ``--data-parallel`` paths: the frames of an encode
split over ``world`` devices equal the one-device encode (rtol 1e-5), and
propagation in tile-row bands over ``world`` devices equals the unbanded
one bitwise. On one card every rank and band shares ``cuda:0`` (gloo:
NCCL takes one rank a device); on the CPU every one is the CPU.

The losses differ from the JAX dry run's: the dropout masks are drawn by
another generator. ``run_ranks`` takes any table of cases of this form and
a ``runner`` for each, so that a caller can measure its own cases in the
same ranks.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from videowalk_tpu_torch.parallel import multihost

# name -> the step's kind ("patch", "sp" or "ts"), model, clip shape and
# global batch (None: a clip a rank), as __graft_entry__.py's dry run
DRYRUN_CASES = dict(
    patch=dict(kind="patch", batch=None, T=4, N=4, px=32,
               model=dict(model_type="scratch")),
    sp=dict(kind="sp", batch=None, T=4, px=32, n_segments=6,
            model=dict(model_type="scratch_zeropad", max_sp_num=8)),
    ts=dict(kind="ts", batch=None, T=4, N=4, px=32,
            model=dict(model_type="scratch_zeropad")),
)
TS_ALPHA = 0.5


def case_model(case: dict, seed: int):
    """The case's model at its seeded init (teacher-student: the teacher
    frozen at its init)."""
    from videowalk_tpu_torch.models import (CRW, CRWConfig,
                                            CRWTeacherStudent)

    cfg = CRWConfig(temperature=0.05, edgedrop_rate=0.1, **case["model"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if case["kind"] == "ts":
            return CRWTeacherStudent(cfg, alpha=TS_ALPHA)
        return CRW(cfg)


def _inputs(case: dict, B: int, device, seed: int):
    """The global batch, made on ``device`` from ``seed`` (every rank
    makes the same and keeps its rows): patches ``(B, T, N, px, px, 3)``,
    or frames in [0, 1] ``(B, T, px, px, 3)`` and, with ``randomise``, the
    SLIC active counts ``n_segments +- randomise / 2`` of each frame."""
    g = torch.Generator(device).manual_seed(seed)
    T, px = case["T"], case["px"]
    if case["kind"] != "sp":
        return torch.randn((B, T, case["N"], px, px, 3), generator=g,
                           device=device), None
    frames = torch.rand((B, T, px, px, 3), generator=g, device=device)
    n_active = None
    if case.get("randomise"):
        half = case["randomise"] // 2
        n = case["n_segments"]
        n_active = np.random.RandomState(seed).randint(n - half, n + half,
                                                       (B * T,))
    return frames, n_active


def case_steps(case: dict, device, group=None, seed: int = 0):
    """Set ``case`` up on ``device`` for ``make_train_step`` (the optimizer
    is ``case.get("optim", "adam")`` at lr 3e-4): with a process ``group``,
    on this rank's row block of the global batch (BN, gradients and draws
    over the group), else one process on all of it. Returns the train state
    and ``step(i)``, which takes step ``i`` and returns its global loss."""
    from videowalk_tpu_torch.core.rng import GlobalBatchGenerator
    from videowalk_tpu_torch.ops.slic import slic_fused
    from videowalk_tpu_torch.parallel import (create_train_state,
                                              make_optimizer, make_train_step,
                                              shard_batch)

    device = torch.device(device)
    rank, world = ((multihost.rank(), multihost.world()) if group is not None
                   else (0, 1))
    B = case["batch"] or world
    x, n_active = _inputs(case, B, device, seed + 1)
    x = shard_batch(x, rank, world)
    if n_active is not None:
        b, T = B // world, case["T"]
        n_active = torch.from_numpy(n_active[rank * b * T:(rank + 1) * b * T]
                                    .astype(np.int32)).to(device)
    state = create_train_state(
        case_model(case, seed),
        make_optimizer(lr=3e-4, optim=case.get("optim", "adam")),
        device=device,
        frozen_prefixes=("teacher.",) if case["kind"] == "ts" else (),
        group=group)
    train_step = make_train_step()

    def step(i: int) -> float:
        gen = (GlobalBatchGenerator(device, rank, world) if group is not None
               else torch.Generator(device)).manual_seed(seed + 100 + i)
        kw = {}
        if case["kind"] == "sp":       # SLIC each step, as the trainer does
            kw["sp_mask"] = (
                slic_fused(x, case["n_segments"], 50.0) if n_active is None
                else slic_fused(x, case["model"]["max_sp_num"], 50.0,
                                n_active=n_active))
        return float(train_step(state, x, gen, **kw)["loss"])

    return state, step


def run_case(case: dict, device, group=None, steps: int = 1) -> dict:
    """``steps`` steps of ``case`` (``case_steps``); returns the global
    losses."""
    _, step = case_steps(case, device, group)
    return dict(losses=[step(i) for i in range(steps)])


def _worker(rank: int, world: int, port: int, device: str, backend: str,
            cases: dict, steps: int, runner, out: str) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    multihost.initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}", num_processes=world,
        process_id=rank, backend=backend, device=device)
    try:
        import torch.distributed as dist

        dev = multihost.local_device(device)
        res = {n: runner(c, dev, dist.group.WORLD, steps)
               for n, c in cases.items()}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


def run_ranks(cases: dict, world: int, device: str = "cuda",
              backend: str | None = None, steps: int = 1,
              runner=run_case) -> list[dict]:
    """``runner(case, device, group, steps)`` of each of ``cases`` (a table
    of the form of ``DRYRUN_CASES``) on ``world`` spawned ranks over
    ``backend`` (the device's default: ``nccl`` on a card, ``gloo`` on the
    CPU); returns each rank's ``{name: runner's result}``. ``runner`` is
    pickled by name: a module's function (a script's, if its main is
    guarded)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out:
        mp.spawn(_worker, args=(world, port, device, backend, dict(cases),
                                steps, runner, out), nprocs=world, join=True)
        return [torch.load(os.path.join(out, f"rank{r}.pt"))
                for r in range(world)]


def check_eval(world: int, device) -> dict:
    """The eval's ``--data-parallel`` paths over ``[device] * world``: the
    split encode against one device's (rtol 1e-5, atol 1e-6), the banded
    propagation against the unbanded one (bitwise), as the JAX dry run
    holds them; raises where either differs."""
    from videowalk_tpu_torch.cli.test import encode_video, replicate_model
    from videowalk_tpu_torch.eval.propagation import (context_index_bank,
                                                      propagate_labels)
    from videowalk_tpu_torch.models import CRW, CRWConfig
    from videowalk_tpu_torch.ops.prop_sparse import TQ

    device = torch.device(device)
    devices = [device] * world
    rng = np.random.RandomState(0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(6)
        model = CRW(CRWConfig(model_type="scratch_zeropad",
                              remove_layers=("layer4",))).to(device).eval()
    frames = rng.randint(0, 255, (2 * world + 1, 32, 32, 3)).astype(np.uint8)
    single = encode_video(model, frames, batch_size=2)
    split = encode_video(model, frames, batch_size=2,
                         replicas=replicate_model(model, devices))
    torch.testing.assert_close(split, single, rtol=1e-5, atol=1e-6)

    H, W, n_lbl, n_context, n_targets, C = TQ * world, TQ, 3, 2, 2, 8
    feats = rng.randn(n_targets + n_context, C, H, W).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    lbl0 = np.zeros((n_targets + n_context, H, W, n_lbl), np.float32)
    lbl0[:n_context + 1] = np.eye(n_lbl, dtype=np.float32)[
        rng.randint(0, n_lbl, (H, W))]
    kw = dict(n_context=n_context, n_long=1, topk=3, temperature=0.07,
              radius=3.0)
    idx = context_index_bank(n_context, [0], n_targets)
    f = torch.from_numpy(feats).to(device)
    want = propagate_labels(f, torch.from_numpy(lbl0), idx, **kw)
    got = propagate_labels(f, torch.from_numpy(lbl0), idx, devices=devices,
                           **kw)
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError("banded propagation differs from unbanded")
    return dict(encode_max_abs_err=float((split - single).abs().max()),
                prop_bitwise=True)


def dryrun_multichip(world: int = 2, device: str = "cuda",
                     backend: str | None = None) -> dict:
    """One step each of patch CRW, superpixel CRW and teacher-student on
    ``world`` ranks, then the eval checks; prints and returns the losses."""
    return report(run_ranks(DRYRUN_CASES, world, device, backend), world,
                  device)


def report(ranks: list[dict], world: int, device) -> dict:
    """The dry run's checks on ``run_ranks``' results for ``DRYRUN_CASES``
    (first-step losses finite and equal on every rank), then the eval
    checks (``check_eval``); prints and returns the losses."""
    losses = {n: ranks[0][n]["losses"][0] for n in DRYRUN_CASES}
    for n, loss in losses.items():
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite {n} loss in the dry run: {loss}")
        if any(r[n]["losses"] != ranks[0][n]["losses"] for r in ranks):
            raise AssertionError(f"the ranks report other {n} losses")
    ev = check_eval(world, multihost.local_device(device))
    print(f"dryrun_multichip({world}): OK, loss={losses['patch']:.4f}, "
          f"sp_loss={losses['sp']:.4f}, ts_loss={losses['ts']:.4f}, "
          f"eval_dp=ok (max abs err {ev['encode_max_abs_err']:.2e}), "
          f"prop_bands=ok", flush=True)
    return dict(losses=losses, eval=ev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--backend", default=None,
                    help="gloo | nccl (default: nccl on a card, gloo on the "
                         "CPU; two ranks on one card need gloo)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.world, args.device, args.backend)


if __name__ == "__main__":
    main()
