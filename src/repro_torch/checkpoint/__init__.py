"""Atomic train-state checkpoints in the JAX package's on-disk format."""
from repro_torch.checkpoint.checkpointer import (Checkpointer, latest_step,
                                                 restore_train_state,
                                                 save_train_state)

__all__ = ["Checkpointer", "latest_step", "restore_train_state",
           "save_train_state"]
