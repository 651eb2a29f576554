"""Training step (single device; multi-GPU is queued)."""

from videowalk_tpu_torch.parallel.train_step import (TrainState,
                                                     create_train_state,
                                                     make_optimizer,
                                                     make_train_step)

__all__ = ["TrainState", "create_train_state", "make_optimizer",
           "make_train_step"]
