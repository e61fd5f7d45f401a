"""Checkpoints of the port (`store.CheckpointManager`), in the reference's
layout, so that either package restores what the other wrote."""

from repro_torch.checkpoint.store import CheckpointManager

__all__ = ["CheckpointManager"]
