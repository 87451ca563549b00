"""Attention: the blocked (flash-style) prefill path and the decode path
(the port of ``repro/models/attention.py``).

``blocked_attention`` launches K5 (``kernels/flash_attn``) on a CUDA tensor
and runs its plain version, a copy of the JAX scan, on a CPU tensor.
``decode_attention`` (one new token against the KV cache) and
``decode_attention_seqsharded`` (the same over a cache whose sequence dim
is split across the ranks of a device mesh) are plain PyTorch, with
``torch.distributed`` functional collectives in the second, as the JAX
package computes them in jnp (inside ``shard_map``), outside any Pallas
kernel.
"""
from __future__ import annotations

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels.flash_attn.flash_attn import flash_attention
from repro_torch.kernels.flash_attn.ref import NEG_INF, _repeat_kv, scaled_query
from repro_torch.models.sharding import local_on_mesh, splits_heads


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


def attend_on_mesh(attend, q, k, v, **kw):
    """``attend(q, k, v, **kw)`` (K5's wrapper or its plain version); on a
    device mesh (DTensor ``q``), on each rank's rows and heads
    (``local_on_mesh``), the keys and values repeated to the query heads
    first, so that a rank's heads split over ``model`` are whole
    attention problems."""

    if not isinstance(q, DTensor):
        return attend(q, k, v, **kw)
    groups = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, groups), _repeat_kv(v, groups)
    return local_on_mesh(lambda q_, k_, v_: attend(q_, k_, v_, **kw), (q, k, v),
                         [(0, 2)] * 3, [(0, 2)], splits_heads(q.shape[2]))


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S, KV, hd)
    v_cache: torch.Tensor,  # (B, S, KV, hd)
    cache_len: torch.Tensor,  # (B,) valid lengths
    sliding_window: int = 0,
) -> torch.Tensor:
    """Single-token attention against a KV cache; on a device mesh, on each
    rank's rows of the cache (its heads whole, as the cache's plan keeps
    them)."""

    if isinstance(q, DTensor) or isinstance(k_cache, DTensor):
        return local_on_mesh(
            lambda *a: decode_attention(*a, sliding_window=sliding_window),
            (q, k_cache, v_cache, cache_len), [(0, None)] * 4, [(0, None)], False)
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


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """A functional all-reduce (``CommDebugMode`` sees it), waited on."""

    return funcol.wait_tensor(funcol.all_reduce(t, op, group))


def _seqsharded_local(q, k_, v_, cl_, group, idx: int, kn_, vn_):
    """One rank's part of ``decode_attention_seqsharded`` on its local
    shards; writes the owner shard's insert into ``k_`` / ``v_`` in place."""
    b, shard_len, kvh, hd = k_.shape
    h = q.shape[2]
    groups = h // kvh
    dev = k_.device
    if kn_ is not None:
        # owner-shard write of the new token at global position cl_
        local_pos = cl_.long() - idx * shard_len  # (B,)
        owner = (local_pos >= 0) & (local_pos < shard_len)
        safe = torch.clamp(local_pos, 0, shard_len - 1)
        bidx = torch.arange(b, device=dev)
        k_[bidx, safe] = torch.where(owner[:, None, None], kn_[:, 0], k_[bidx, safe])
        v_[bidx, safe] = torch.where(owner[:, None, None], vn_[:, 0], v_[bidx, safe])
        cl_ = cl_ + 1
    qf = scaled_query(q[:, 0]).reshape(b, kvh, groups, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k_.float())
    pos = idx * shard_len + torch.arange(shard_len, device=dev)
    mask = pos[None, :] < cl_[:, None]
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    m_glob = _all_reduce(scores.amax(dim=-1), "max", group)
    p = torch.exp(scores - m_glob[..., None])
    l_glob = _all_reduce(p.sum(dim=-1), "sum", group)
    o_glob = _all_reduce(torch.einsum("bkgs,bskd->bkgd", p, v_.float()), "sum", group)
    out = o_glob / torch.clamp(l_glob, min=1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)


def decode_attention_seqsharded(
    q: torch.Tensor,  # (B, 1, H, hd), the same on every rank
    k_cache: torch.Tensor,  # this rank's (B, S/n, KV, hd), or a DTensor (B, S, KV, hd)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) valid lengths (global positions)
    mesh,  # a DeviceMesh with ``seq_axis``
    seq_axis: str = "data",
    k_new=None,  # (B, 1, KV, hd) token to insert
    v_new=None,
):
    """long_500k decode: the KV cache's sequence dim is split over
    ``seq_axis`` of ``mesh``, rank r of it holding positions ``[r S/n, (r
    + 1) S/n)``.  The new token's keys and values are written by the shard
    that owns global position ``cache_len`` (no other writes), each shard
    scores the query against its positions below ``cache_len + 1``, and the
    partial softmaxes are combined exactly: an all-reduce MAX of the local
    maxima, then SUM of the local sums and outputs, over ``seq_axis``'s
    group (functional collectives).

    As in the JAX package's ``shard_map`` version: no sliding-window mask,
    and the insert is not clamped to the last slot, so at ``cache_len >=
    S`` no shard writes (``_attention_decode``'s unsharded path clamps).

    ``k_cache`` / ``v_cache`` are either this rank's shards (plain
    tensors) or DTensors laid out ``Shard(1)`` over ``seq_axis`` and
    replicated over the other axes; then ``q``, ``cache_len`` and the new
    token are made replicated first, and the result is a replicated
    DTensor.  Returns ``(out (B, 1, H, hd), k_cache, v_cache)``, the
    caches written in place."""

    dim = mesh.mesh_dim_names.index(seq_axis)
    group = (mesh, dim)
    idx = mesh.get_local_rank(seq_axis)
    rep = [Replicate()] * mesh.ndim

    def local(t):
        return t.redistribute(t.device_mesh, rep).to_local() if isinstance(t, DTensor) else t

    q, cache_len, k_new, v_new = map(local, (q, cache_len, k_new, v_new))
    if not isinstance(k_cache, DTensor):
        out = _seqsharded_local(q, k_cache, v_cache, cache_len, group, idx, k_new, v_new)
        return out, k_cache, v_cache
    out = _seqsharded_local(q, k_cache.to_local(), v_cache.to_local(), cache_len, group, idx,
                            k_new, v_new)
    return DTensor.from_local(out, mesh, rep, run_check=False), k_cache, v_cache


__all__ = ["blocked_attention", "decode_attention", "decode_attention_seqsharded"]
