"""Error-feedback int8 gradient compression for the cross-pod all-reduce
(the port of ``repro/optim/grad_compress.py``).

Gradients are quantized to int8 with a per-tensor scale; the quantization
residual is carried in an error-feedback buffer so the compression is
unbiased over time (EF-SGD).  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 codes equal the JAX package's bit for bit.
Over a dict of tensors; ``train.py --grad-compress`` allocates the buffer.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x32 = x.float()
    scale = torch.amax(torch.abs(x32)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def error_feedback_update(grads: Tensors, error_buf: Tensors) -> Tuple[Tensors, Tensors]:
    """Compress (grads + carried error); return (dequantized, new error)."""
    deq, err = {}, {}
    for k, g in grads.items():
        target = g.float() + error_buf[k]
        q, s = compress_int8(target)
        d = decompress_int8(q, s)
        deq[k] = d.to(g.dtype)
        err[k] = target - d
    return deq, err


def init_error_buf(params: Tensors) -> Tensors:
    # zeros_like keeps a DTensor parameter's layout
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
