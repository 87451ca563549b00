"""Plain PyTorch versions of K5: the oracle ``attention_ref`` (the JAX
package's ``kernels/flash_attn/ref.py``, full softmax over a ``(BH, S,
hd)`` layout) and ``blocked_attention_plain``, a line-for-line copy of
``repro/models/attention.py::blocked_attention`` (online softmax over KV
blocks, float32 ``m`` / ``l`` / ``acc``), which the K5 wrapper runs on CPU
tensors."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (BH, Sq, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sliding_window: int = 0,
) -> torch.Tensor:
    hd = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (hd**-0.5)
    sq, skv = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if sliding_window:
        mask &= k_pos > q_pos - sliding_window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*groups, hd) for GQA."""
    if groups == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(b, s, kv * groups, hd)


def scaled_query(q: torch.Tensor) -> torch.Tensor:
    """blocked_attention's ``(q * scale).astype(float32)``: the product is
    taken in q's dtype, with the scale rounded to that dtype first."""
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)
    return (q * scale.to(q.device)).float()


def blocked_attention_plain(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    causal: bool = True,
    sliding_window: int = 0,
    q_offset: int = 0,
    block_size: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``block_size``."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    groups = h // k.shape[2]
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    qf = scaled_query(q)
    dev = q.device
    nblocks = -(-skv // block_size)
    pad = nblocks * block_size - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=dev)
    for blk in range(nblocks):
        kblk = k[:, blk * block_size:(blk + 1) * block_size]
        vblk = v[:, blk * block_size:(blk + 1) * block_size]
        k_pos = blk * block_size + torch.arange(block_size, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kblk.float())
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((sq, block_size), dtype=torch.bool, device=dev)
        if sliding_window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - sliding_window)
        mask = mask & (k_pos < skv)[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk.float())
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B, Sq, H, hd)


__all__ = ["NEG_INF", "attention_ref", "blocked_attention_plain", "scaled_query"]
