"""Crash-consistent checkpoints of tensor trees on npz."""

from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_pytree,
    save_pytree,
    write_json_atomic,
)

__all__ = ["save_pytree", "restore_pytree", "CheckpointManager",
           "latest_step", "write_json_atomic"]
