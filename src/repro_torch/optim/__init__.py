"""Optimizer substrate: AdamW + cosine schedule + gradient compression
(the port of ``repro/optim``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.optim.grad_compress import (
    compress_int8,
    decompress_int8,
    error_feedback_update,
)

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "compress_int8",
    "decompress_int8",
    "error_feedback_update",
]
