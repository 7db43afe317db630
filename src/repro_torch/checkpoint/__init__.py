"""Atomic, async, retention-managed checkpointing (from
``repro.checkpoint``), on the reference's on-disk layout."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
