"""Core NN layers: RMSNorm, RoPE / M-RoPE, SwiGLU, initializers (the port
of ``repro/models/layers.py``).

The dtype casts are the JAX package's: ``rms_norm``, ``rope`` and ``mrope``
compute in float32 and return the activation dtype; weights are cast to
the activation dtype before each product.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def rope(
    x: torch.Tensor,  # (..., S, H, hd)
    positions: torch.Tensor,  # (..., S)
    theta: float = 1e4,
) -> torch.Tensor:
    """Standard rotary embedding (half-split convention)."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope(
    x: torch.Tensor,  # (..., S, H, hd)
    positions3: torch.Tensor,  # (..., 3, S): t/h/w position ids
    sections: Tuple[int, int, int],
    theta: float = 1e6,
) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): rotary half-dims are split into t/h/w
    sections, each rotated by its own position stream."""
    hd = x.shape[-1]
    half = hd // 2
    assert sum(sections) == half, (sections, half)
    freqs = _rope_freqs(hd, theta, x.device)  # (half,)
    # Select which position stream drives each frequency slot.
    sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                          device=x.device)  # (half,)
    # positions3: (..., 3, S) -> (..., S, half)
    moved = positions3.movedim(-2, -1)  # (..., S, 3)
    pos = torch.gather(moved, -1, sec_id.expand(moved.shape[:-1] + (half,)))
    ang = pos.float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g) * u) @ w_down.to(x.dtype)


def dense_init(
    generator: torch.Generator,
    shape: Sequence[int],
    in_axis: int = 0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn from ``generator``, on the
    generator's device (a CUDA generator draws on the card)."""
    fan_in = shape[in_axis]
    std = (1.0 / fan_in) ** 0.5
    w = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return (w * std).to(dtype)


__all__ = ["dense_init", "mrope", "rms_norm", "rope", "swiglu"]
