"""Attention: the blocked (flash-style) prefill path and the decode path
(the port of ``repro/models/attention.py``).

``blocked_attention`` launches K5 (``kernels/flash_attn``) on a CUDA tensor
and runs its plain version, a copy of the JAX scan, on a CPU tensor.
``decode_attention`` (one new token against the KV cache) is plain
PyTorch, as the JAX package computes it outside any Pallas kernel.  The
sequence-sharded decode needs a device mesh and waits for the port's
distributed slice (``ROADMAP.md``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn.flash_attn import flash_attention
from repro_torch.kernels.flash_attn.ref import NEG_INF, scaled_query


def blocked_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    causal: bool = True,
    sliding_window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention; K5 on the card, its plain version
    (``blocked_attention_plain``, KV blocks of 1024) on the CPU."""
    return flash_attention(q, k, v, causal=causal, sliding_window=sliding_window,
                           q_offset=q_offset)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S, KV, hd)
    v_cache: torch.Tensor,  # (B, S, KV, hd)
    cache_len: torch.Tensor,  # (B,) valid lengths
    sliding_window: int = 0,
) -> torch.Tensor:
    """Single-token attention against a KV cache."""
    b, s, kv, hd = k_cache.shape
    h = q.shape[2]
    groups = h // kv
    qf = scaled_query(q[:, 0]).reshape(b, kv, groups, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())  # (B,KV,G,S)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] < cache_len[:, None]  # (B,S)
    if sliding_window:
        mask = mask & (pos[None, :] >= cache_len[:, None] - sliding_window)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def decode_attention_seqsharded(*args, **kwargs):
    raise NotImplementedError(
        "decode_attention_seqsharded needs a device mesh; the port's distributed "
        "decode is still to be ported (ROADMAP.md, queue 1)")


__all__ = ["blocked_attention", "decode_attention", "decode_attention_seqsharded"]
