"""Multi-process training and eval over ``torch.distributed`` (counterpart
of ``videowalk_tpu/parallel/multihost.py``).

One process per card (the JAX package runs one per host over one global
mesh). Deployment contract, as in the JAX package:

- every process runs the same program (same flags, same seed), so the host
  draws that steer control flow (the patch/superpixel Bernoulli, the
  stochastic-checkpoint coin, SLIC's active counts) are equal on every rank;
- ``--batch-size`` is the global batch: each process loads
  ``batch // world`` clips from its disjoint sampler shard
  (``DataLoader(shard=(rank, world))``);
- only rank 0 writes checkpoints and logs (``is_primary``).

The backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU, chosen
from the device. A failed init raises: nothing carries on as a single
process.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

_TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           device: str | torch.device = "cuda") -> int:
    """Join (or form) the process group; returns its world size.

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``, the group forms over ``tcp://host:port``; without them
    it reads ``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``WORLD_SIZE`` (``env://``). ``backend`` defaults to ``nccl`` where
    ``device`` is a CUDA device and ``gloo`` where it is the CPU. On a CUDA
    device the process's card (``local_device``) becomes the current one
    before the group forms."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError(
                "a manual cluster needs --coordinator-address, "
                "--num-processes and --process-id together")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=int(num_processes), rank=int(process_id))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init = dict(init_method="env://")
    else:
        raise RuntimeError(
            "--distributed needs torchrun's RANK/WORLD_SIZE/MASTER_ADDR/"
            "MASTER_PORT or --coordinator-address, --num-processes and "
            "--process-id")
    if dev.type == "cuda":
        rank_hint = (int(process_id) if process_id is not None
                     else int(os.environ["RANK"]))
        torch.cuda.set_device(local_device(dev, rank_hint))
    dist.init_process_group(backend=backend, timeout=_TIMEOUT, **init)
    return dist.get_world_size()


def initialize_from_args(args) -> int:
    """CLI hook: ``--distributed [--coordinator-address H:P
    --num-processes N --process-id I]`` on ``--device``. Returns the world
    size (1 without ``--distributed``)."""
    if not getattr(args, "distributed", False):
        return 1
    pid = getattr(args, "process_id", -1)
    n = getattr(args, "num_processes", 0)
    return initialize_distributed(
        coordinator_address=getattr(args, "coordinator_address", "") or None,
        num_processes=n if n and n > 0 else None,
        process_id=pid if pid is not None and pid >= 0 else None,
        device=getattr(args, "device", "cuda"))


def world() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the one process that writes checkpoints and logs."""
    return rank() == 0


def local_device(device: str | torch.device = "cuda",
                 rank_hint: int | None = None) -> torch.device:
    """This process's device: the CPU for a CPU ``device``; a CUDA device
    with an index as given; else ``cuda:LOCAL_RANK`` (``torchrun`` sets
    it), or the rank modulo the visible cards."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    r = rank() if rank_hint is None else rank_hint
    return torch.device("cuda", r % max(1, torch.cuda.device_count()))


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
