"""Atomic step checkpoints of numpy trees and train states (the store's
chunk resume, the training driver's restarts)."""
from repro_torch.checkpoint.ckpt import (all_steps, flatten, latest_step,
                                         restore, restore_into, save)

__all__ = ["save", "restore", "restore_into", "flatten", "latest_step",
           "all_steps"]
