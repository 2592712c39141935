"""Atomic, keep-k, async checkpoints (``repro.ckpt``)."""
from .manager import (CheckpointManager, available_steps, restore_checkpoint,
                      save_checkpoint)

__all__ = ["CheckpointManager", "available_steps", "restore_checkpoint",
           "save_checkpoint"]
