"""Checkpoints of a train state (or any tree of tensors), in the
reference's on-disk format: ``manifest.json`` and ``arrays.npz``."""
from .checkpoint import (save_checkpoint, restore_checkpoint, latest_step,
                         AsyncCheckpointer)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]
