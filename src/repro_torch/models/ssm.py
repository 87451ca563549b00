"""Mamba2 / SSD (state-space duality) block (the port of
``repro/models/ssm.py``).

``ssd_chunked`` launches K6 (``kernels/ssd_scan``) on a CUDA tensor and runs
its plain version on a CPU tensor; both mask the intra-chunk decay before
the exponent, where the JAX function masks after it and gives NaN at long
chunks (``kernels/ssd_scan/ref.py``).  ``ssm_block`` and the O(1)
recurrent ``ssm_decode_step`` are plain PyTorch with the JAX package's
casts: y comes back from the scan in x's dtype, the ``D`` skip and the
gated RMSNorm run in float32, and the output projection in x's dtype.

Shapes: d_inner = expand * d_model; H = d_inner / head_dim; P = head_dim;
N = ssm_state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan


class SSMParams(NamedTuple):
    w_in: torch.Tensor  # (D, 2*d_inner + 2*N + H)  -> x, z, B, C, dt
    a_log: torch.Tensor  # (H,)
    d_skip: torch.Tensor  # (H,)
    dt_bias: torch.Tensor  # (H,)
    norm: torch.Tensor  # (d_inner,)
    w_out: torch.Tensor  # (d_inner, D)


def _split_proj(zxbcdt, d_inner, n_state, n_heads):
    return torch.split(zxbcdt, [d_inner, d_inner, n_state, n_state, n_heads], dim=-1)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) softplus'd step sizes, float32
    a: torch.Tensor,  # (H,) negative decay rates, float32
    b_proj: torch.Tensor,  # (B, S, N)
    c_proj: torch.Tensor,  # (B, S, N)
    chunk: int = 256,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (K6 on the card).  Returns ``(y (B, S, H, P) in
    x's dtype, final float32 state (B, H, P, N))``."""
    return ssd_scan(x, dt, a, b_proj, c_proj, chunk=chunk, init_state=init_state)


def _gated_out(params: SSMParams, y, z, x_dtype):
    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6)) * params.norm
    return y.to(x_dtype) @ params.w_out.to(x_dtype)


def ssm_block(
    params: SSMParams,
    x: torch.Tensor,  # (B, S, D)
    cfg,
    init_state: Optional[torch.Tensor] = None,
):
    """Full Mamba2 block: in-proj -> SSD -> gated RMSNorm -> out-proj."""
    d_inner = cfg.ssm_expand * cfg.d_model
    h = d_inner // cfg.ssm_head_dim
    n = cfg.ssm_state
    zxbcdt = x @ params.w_in.to(x.dtype)
    xi, z, b, c, dt = _split_proj(zxbcdt, d_inner, n, h)
    dt = F.softplus(dt.float() + params.dt_bias)
    a = -torch.exp(params.a_log.float())
    xh = xi.reshape(*xi.shape[:-1], h, cfg.ssm_head_dim)
    y, state = ssd_chunked(xh, dt, a, b, c, chunk=cfg.ssm_chunk, init_state=init_state)
    y = y + xh.float() * params.d_skip[None, None, :, None]
    y = y.reshape(xi.shape)
    return _gated_out(params, y, z, x.dtype), state


def ssm_decode_step(
    params: SSMParams,
    x: torch.Tensor,  # (B, 1, D)
    state: torch.Tensor,  # (B, H, P, N) float32
    cfg,
):
    """O(1) recurrent decode: h' = h*exp(dt*A) + dt*B x ; y = C·h' + D x."""
    d_inner = cfg.ssm_expand * cfg.d_model
    h = d_inner // cfg.ssm_head_dim
    n = cfg.ssm_state
    zxbcdt = x @ params.w_in.to(x.dtype)
    xi, z, b, c, dt = _split_proj(zxbcdt, d_inner, n, h)
    dt = F.softplus(dt.float() + params.dt_bias)[:, 0]  # (B,H)
    a = -torch.exp(params.a_log.float())
    xh = xi[:, 0].reshape(-1, h, cfg.ssm_head_dim).float()  # (B,H,P)
    bv = b[:, 0].float()  # (B,N)
    cv = c[:, 0].float()
    decay = torch.exp(dt * a[None, :])  # (B,H)
    state = state * decay[:, :, None, None] + torch.einsum("bhp,bn,bh->bhpn", xh, bv, dt)
    y = torch.einsum("bhpn,bn->bhp", state, cv) + xh * params.d_skip[None, :, None]
    y = y.reshape(x.shape[0], 1, d_inner)
    return _gated_out(params, y, z, x.dtype), state


__all__ = ["SSMParams", "ssd_chunked", "ssm_block", "ssm_decode_step"]
