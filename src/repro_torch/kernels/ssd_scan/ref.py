"""Plain PyTorch versions of K6, in the model's layout: x ``(B, S, H, P)``,
dt ``(B, S, H)``, a ``(H,)``, B and C ``(B, S, N)`` shared by all heads.

``ssd_naive`` is the sequential recurrence (the JAX package's
``kernels/ssd_scan/ref.py::ssd_naive``, the ground truth there, written
for this layout with an initial and a final state).
``ssd_chunked_plain`` is ``repro/models/ssm.py::ssd_chunked`` with one
change: the intra-chunk decay ``exp(cum_t - cum_s)`` is taken only where
``s <= t`` and is 0 elsewhere.  The reference exponentiates every
``(t, s)`` and masks afterwards; for ``s > t`` the exponent is positive and
at long chunks (zamba2's 256, with dt ~ 0.8 and a = -1) it overflows to
inf, and ``inf * 0`` makes y NaN.  Wherever the reference is finite the two
agree.  The K6 wrapper runs ``ssd_chunked_plain`` on CPU tensors.
``ssd_three_pass_plain`` computes the same function in the order of the
CUDA kernels' three passes (``csrc/ssd_step.h``); the tests hold it
against the other two.  Neither is on the main path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_naive(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h' = h exp(dt a) + (dt x) B^T; y = h C``, one position at a time.
    Returns ``(y in x's dtype, final float32 state (B, H, P, N))``."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float().clone())
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    a = a.float()
    for t in range(s):
        dtt = dt[:, t].float()  # (B, H)
        decay = torch.exp(dtt * a[None, :])
        xdt = x[:, t].float() * dtt[..., None]  # (B, H, P)
        state = state * decay[..., None, None] + xdt[..., None] * b[:, t].float()[:, None, None, :]
        y[:, t] = torch.einsum("bhpn,bn->bhp", state, c[:, t].float())
    return y.to(x.dtype), state


def ssd_chunked_plain(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) softplus'd step sizes
    a: torch.Tensor,  # (H,) negative decay rates
    b_proj: torch.Tensor,  # (B, S, N)
    c_proj: torch.Tensor,  # (B, S, N)
    chunk: int = 256,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan with the decay masked before the exponent.
    Returns ``(y (B, S, H, P) in x's dtype, final float32 state)``."""
    bsz, s, h, p = x.shape
    n = b_proj.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_proj = F.pad(b_proj, (0, 0, 0, pad))
        c_proj = F.pad(c_proj, (0, 0, 0, pad))
    xc = x.reshape(bsz, nc, chunk, h, p).float()
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    bc = b_proj.reshape(bsz, nc, chunk, n).float()
    cc = c_proj.reshape(bsz, nc, chunk, n).float()

    cum = torch.cumsum(dtc * a.float()[None, None, None, :], dim=2)  # (B,C,L,H)
    idx = torch.arange(chunk, device=x.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]  # t >= s
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,C,L,L,H)
    decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)
    w = cb[..., None] * decay
    y_intra = torch.einsum("bctsh,bcshp->bcthp", w, xc * dtc[..., None])
    state_w = torch.exp(cum[:, :, -1:, :] - cum) * dtc  # (B,C,L,H)
    chunk_states = torch.einsum("bcsn,bcsh,bcshp->bchpn", bc, state_w, xc)
    seg_decay = torch.exp(cum[:, :, -1])  # (B,C,H)

    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = state * seg_decay[:, ci, :, None, None] + chunk_states[:, ci]
    prev_states = torch.stack(prev, dim=1)  # (B,C,H,P,N)
    y_state = torch.einsum("bcln,bclh,bchpn->bclhp", cc, torch.exp(cum), prev_states)
    y = (y_intra + y_state).reshape(bsz, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), state


def ssd_three_pass_plain(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    a: torch.Tensor,  # (H,)
    b_proj: torch.Tensor,  # (B, S, N)
    c_proj: torch.Tensor,  # (B, S, N)
    chunk: int = 256,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan as the CUDA kernels split it, in float32:

    A. per (batch, chunk, head): cum, cum[L-1] and the chunk's own state
       ``dS^T = (w B)^T x`` with ``w[s] = exp(cum[L-1] - cum[s]) dt[s]``;
    B. per (batch, head): ``S_c = exp(cum_c[L-1]) S_{c-1} + dS_c``, keeping
       each chunk's starting state;
    C. per (batch, chunk, head): ``y = exp(cum) C S_{c-1}^T + G x`` with
       ``G[t][s] = (C[t].B[s]) exp(cum[t] - cum[s]) dt[s]`` for ``s <= t``.

    Returns ``(y in x's dtype, final float32 state)``."""
    bsz, s, h, p = x.shape
    n = b_proj.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, chunk, h, p)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(bsz, nc, chunk, h)
    bc = F.pad(b_proj.float(), (0, 0, 0, pad)).reshape(bsz, nc, chunk, n)
    cc = F.pad(c_proj.float(), (0, 0, 0, pad)).reshape(bsz, nc, chunk, n)
    # A
    cum = torch.cumsum(dtc * a.float(), dim=2)  # (B, C, L, H)
    last = cum[:, :, -1]  # (B, C, H)
    w = torch.exp(last[:, :, None] - cum) * dtc
    ds_t = torch.einsum("bcsh,bcsn,bcshp->bchnp", w, bc, xc)
    # B
    state_t = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
               if init_state is None else init_state.float().transpose(2, 3))
    starts = []
    for ci in range(nc):
        starts.append(state_t)
        state_t = state_t * torch.exp(last[:, ci])[..., None, None] + ds_t[:, ci]
    s_prev = torch.stack(starts, dim=1)  # (B, C, H, N, P)
    # C
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)
    idx = torch.arange(chunk, device=x.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    diff = torch.where(mask, cum[:, :, :, None, :] - cum[:, :, None, :, :], 0.0)
    g = torch.where(mask, cb[..., None] * torch.exp(diff) * dtc[:, :, None], 0.0)  # (B,C,T,S,H)
    y = (torch.exp(cum)[..., None] * torch.einsum("bctn,bchnp->bcthp", cc, s_prev)
         + torch.einsum("bctsh,bcshp->bcthp", g, xc))
    y = y.reshape(bsz, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), state_t.transpose(2, 3).contiguous()


__all__ = ["ssd_chunked_plain", "ssd_naive", "ssd_three_pass_plain"]
