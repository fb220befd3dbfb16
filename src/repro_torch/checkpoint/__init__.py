"""Checkpointing: committed per-step shard files, async save, keep-k GC."""
from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          read_leaves, read_tree,
                                          restore_state, save_state)

__all__ = ["CheckpointManager", "latest_step", "read_leaves", "read_tree",
           "restore_state", "save_state"]
