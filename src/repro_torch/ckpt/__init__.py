"""Atomic, self-describing checkpoints in the JAX package's file format."""
from repro_torch.ckpt.checkpoint import (CheckpointManager, restore_tree,
                                         save_tree)

__all__ = ["CheckpointManager", "restore_tree", "save_tree"]
