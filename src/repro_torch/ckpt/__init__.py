"""Checkpoints (port of ``src/repro/ckpt``), in the reference's layout."""
from repro_torch.ckpt.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]
