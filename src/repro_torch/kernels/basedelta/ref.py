"""Plain PyTorch oracle for the BaseΔ tile kernels (K3a, K3b).

The arithmetic is JAX's int32, which wraps: the subtraction, the absolute
value and the addition are done in int64 and wrapped back into int32, so
``abs(INT32_MIN)`` stays ``INT32_MIN`` as ``jnp.abs`` leaves it.  These are
also the kernels' plain versions (:mod:`.basedelta`).
"""
from __future__ import annotations

import torch


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def compress_ref(blocks: torch.Tensor, counts: torch.Tensor):
    """``(deltas (E, W) int32, mode (E,) int32)`` of entry rows ``blocks``
    (E, W) int32 with ``counts`` (E,) valid columns each."""
    lane = torch.arange(blocks.shape[1], device=blocks.device)[None, :]
    valid = lane < counts[:, None]
    x = blocks.to(torch.int64)
    deltas = _wrap32(torch.where(valid, x - x[:, 0:1], 0))
    absmax = _wrap32(deltas.to(torch.int64).abs()).amax(dim=1)
    mode = torch.where(absmax <= 127, 0, torch.where(absmax <= 32767, 1, 2))
    return deltas, mode.to(torch.int32)


def decompress_ref(base: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """``base[:, None] + deltas`` in wrapping int32."""
    return _wrap32(base.to(torch.int64)[:, None] + deltas.to(torch.int64))


__all__ = ["compress_ref", "decompress_ref"]
