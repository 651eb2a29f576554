"""Training step and data parallelism over ``torch.distributed``.

The counterpart of ``videowalk_tpu/parallel``: one process per card
(``multihost``), each stepping its row block of the global batch; BN's
moments and Sinkhorn's stop test span the global batch, the gradients are
averaged over the process group after the backward pass, and rank 0 alone
writes (``mesh``, ``train_step``). NCCL on the card, gloo on the CPU.
"""

from videowalk_tpu_torch.parallel.mesh import (all_reduce_sum, attach_group,
                                               average_gradients,
                                               global_mean, replicate,
                                               shard_batch)
from videowalk_tpu_torch.parallel.multihost import (initialize_distributed,
                                                    initialize_from_args,
                                                    is_primary,
                                                    local_device, rank,
                                                    shutdown, world)
from videowalk_tpu_torch.parallel.train_step import (TrainState,
                                                     create_train_state,
                                                     make_optimizer,
                                                     make_train_step)

__all__ = ["TrainState", "create_train_state", "make_optimizer",
           "make_train_step", "all_reduce_sum", "attach_group",
           "average_gradients", "global_mean", "replicate", "shard_batch",
           "initialize_distributed", "initialize_from_args", "is_primary",
           "local_device", "rank", "shutdown", "world"]
