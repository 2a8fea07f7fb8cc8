"""Checkpoints of the port, mirroring ``repro.checkpoint``."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
