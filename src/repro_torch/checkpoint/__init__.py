"""Checkpointing: tensor trees <-> npz + JSON manifest, in the reference's
format.

``save_train_state`` / ``restore_train_state`` round-trip the full trainer
state including the compressor (error-feedback) state, each rank's own
with a process group.  Saves are atomic (temp dir + rename) and digest
verified on restore: a corrupted or partial checkpoint raises
:class:`CheckpointCorruptError` instead of deserializing garbage.
"""
from .store import (
    CheckpointCorruptError,
    latest_step,
    load_extra,
    restore,
    restore_train_state,
    save,
    save_train_state,
    verify,
)

__all__ = [
    "CheckpointCorruptError",
    "save",
    "restore",
    "verify",
    "latest_step",
    "load_extra",
    "save_train_state",
    "restore_train_state",
]
