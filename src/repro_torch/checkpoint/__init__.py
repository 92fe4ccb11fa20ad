"""Checkpointing: atomic step-numbered saves in the reference's on-disk
format, an async writer, elastic re-partition of banked tables."""
from repro_torch.checkpoint.ckpt import (
    AsyncCheckpointer,
    latest_step,
    reshard_banked_table,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer", "reshard_banked_table"]
