"""Checkpoints of the port's training state (torch port of
``repro.ckpt``): the JAX package's format 2, so either package restores
the other's files."""
from .manager import (CheckpointCorruptionError, CheckpointError,
                      CheckpointManager, CheckpointNotFoundError,
                      CheckpointWriteError)
