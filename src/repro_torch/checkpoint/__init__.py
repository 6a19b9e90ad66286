"""Checkpointing of the port's state: atomic, async, integrity-checked."""
from repro_torch.checkpoint.checkpointer import (SCHEMA_VERSION,
                                                 CheckpointCorruptError,
                                                 Checkpointer, config_hash)

__all__ = ["Checkpointer", "CheckpointCorruptError", "SCHEMA_VERSION",
           "config_hash"]
