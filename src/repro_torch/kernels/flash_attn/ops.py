"""Public wrapper of K5 in the model's layout, the counterpart of
``repro/kernels/flash_attn/ops.py::mha``.  The JAX wrapper repeats the kv
heads and folds (B, H) into one axis for the Pallas kernel; the CUDA
kernel reads each query head's kv head in place, so no copy is made."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn.flash_attn import flash_attention


def mha(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,
    causal: bool = True,
    sliding_window: int = 0,
) -> torch.Tensor:
    return flash_attention(q, k, v, causal=causal, sliding_window=sliding_window)


__all__ = ["mha"]
