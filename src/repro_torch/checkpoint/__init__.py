"""Fault-tolerant checkpointing (the port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
