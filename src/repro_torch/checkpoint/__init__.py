"""Checkpointing of the port: atomic, async save and restore with
fallback (see ``manager``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
