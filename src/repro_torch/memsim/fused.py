"""Fused multi-level hierarchy engine (PyTorch port of ``repro.memsim.fused``).

One pass carries L1+L2+LLC together, emitting each access's hit level.

**Group decomposition.** Let ``G = min(sets_l)`` over the levels (set
counts are powers of two, so ``G`` divides each).  Group an access ``b`` by
``g = b & (G - 1)``.  Level ``l`` with ``R_l = sets_l / G`` relative sets
per group maps ``b`` to set ``s_l = r_l * G + g`` with
``r_l = (b >> log2(G)) & (R_l - 1)``, so every group exclusively owns
``R_l`` whole sets at every level and groups are independent for the
whole hierarchy at once.

**Run collapse.** Within one group's substream, a repeat of the
immediately preceding block is a guaranteed L1 hit whose only state effect
is re-stamping the MRU line, which leaves the per-set age order unchanged.
:func:`_group_collapse` keeps only the first access of each run, on the
host, before the launch; dropped repeats are emitted as level 0.

**Kernel.** The kept stream, group-sorted and ragged (per-group offsets),
goes to kernel K2 (:func:`repro_torch.kernels.cache_sim.ops.fused_levels`),
one thread per (stream, group); a family of streams is one launch with a
stream axis (:func:`fused_cache_pass_batch`).  On a CPU device the
kernel's plain version runs, and set-skewed streams take the per-level
cascade, as in the JAX package.  The JAX package's XLA-CPU cost-based plan
chooser is not ported: the results are the same either way.

**Carried state.** Per-level states travel in the kernel's group layout
(:func:`state_to_groups`) and come back canonicalized, so they compose
with every engine of either package across shard seams.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.cache_sim.ops import fused_levels
from repro_torch.memsim.engine import (
    CacheState,
    _PAD_FACTOR,
    _PAD_FLOOR_CELLS,
    _block_array,
    _bucket_len,
    cache_pass_fused_select,
    canonicalize_state,
    init_state,
    ragged_offsets,
)


def fused_group_count(levels: Sequence[Tuple[int, int]]) -> int:
    """G = min(sets): the group granularity of a fused pass."""
    return min(sets for sets, _ in levels)


def state_to_groups(tags_or_age: torch.Tensor, groups: int) -> torch.Tensor:
    """Reshape a ``(sets, ways)`` level array to ``(groups, R * ways)`` lanes.

    Set ``s = r * groups + g`` lands at ``[g, r * ways + w]``: lane order
    is ``(relative set, way)``.
    """
    sets, ways = tags_or_age.shape
    r = sets // groups
    return (
        tags_or_age.reshape(r, groups, ways).permute(1, 0, 2).reshape(groups, r * ways)
    )


def state_from_groups(lanes: torch.Tensor, sets: int, ways: int) -> torch.Tensor:
    """Inverse of :func:`state_to_groups`."""
    groups = lanes.shape[0]
    r = sets // groups
    return lanes.reshape(groups, r, ways).permute(1, 0, 2).reshape(sets, ways)


def _group_collapse(blocks: np.ndarray, groups: int):
    """Group the stream and drop run repeats (see *Run collapse* above).

    Returns ``(kept, order, keep, counts)``: ``kept`` (M,) int32 is the
    group-sorted stream without run repeats, ``order`` the stable group-by
    sort permutation of the full stream, ``keep`` the first-of-run mask
    over the sorted stream, and ``counts`` (groups,) the kept lengths.
    Unpack per-access results with::

        sorted_res[keep] = res   # dropped repeats: L1 hit (0)
        out[order] = sorted_res
    """
    b32 = _block_array(blocks).astype(np.int32)
    if groups > 1 << 16:
        raise ValueError("group index must fit the uint16 radix key")
    s = b32 & np.int32(groups - 1)
    order = np.argsort(s.astype(np.uint16), kind="stable")
    bs = b32[order]
    ss = s[order]
    keep = np.ones(len(b32), dtype=bool)
    if len(b32) > 1:
        keep[1:] = (bs[1:] != bs[:-1]) | (ss[1:] != ss[:-1])
    return bs[keep], order, keep, np.bincount(ss[keep], minlength=groups)


def _resolve_states(levels, states, device) -> List[CacheState]:
    if states is None:
        return [init_state(s, w, device) for s, w in levels]
    if len(states) != len(levels):
        raise ValueError("one carried state per level")
    return [st.to(device) for st in states]


def _skewed_padded(counts: np.ndarray, groups: int, stream_len: int) -> bool:
    """CPU padded-matrix blowup guard on the collapsed stream (same budget
    as the per-level engine's)."""
    max_len = _bucket_len(int(counts.max(initial=0)))
    return max_len * groups > max(_PAD_FACTOR * stream_len, _PAD_FLOOR_CELLS)


def _fused_fallback(blocks, levels, states, return_states, device):
    """Per-level cascade on kernel K1 (the CPU skew-guard path): each level
    sees the miss substream of the level above."""
    lvl = np.full(len(blocks), len(levels), dtype=np.int8)
    pos = np.arange(len(blocks), dtype=np.int64)
    sub = np.asarray(blocks)
    out_states = []
    for i, (sets, ways) in enumerate(levels):
        res = cache_pass_fused_select(sub, sets, ways, states[i], return_states, device)
        hit = res[0] if return_states else res
        if return_states:
            out_states.append(res[1])
        lvl[pos[hit]] = i
        pos = pos[~hit]
        sub = sub[~hit]
    return (lvl, out_states) if return_states else lvl


def _unpack_levels(n: int, lvls: np.ndarray, order, keep) -> np.ndarray:
    """Scatter kept-access hit levels back to stream order; dropped run
    repeats are L1 hits (level 0) by construction."""
    sorted_lvl = np.zeros(n, dtype=np.int8)
    sorted_lvl[keep] = lvls
    out = np.empty(n, dtype=np.int8)
    out[order] = sorted_lvl
    return out


def _fused_family(streams, levels, states, device, return_states):
    """One K2 launch over a family of streams (stream axis)."""
    groups = fused_group_count(levels)
    grouped = [_group_collapse(s, groups) for s in streams]
    kept = torch.from_numpy(np.concatenate([g[0] for g in grouped])).to(device)
    offsets = torch.from_numpy(ragged_offsets([g[3] for g in grouped])).to(device)
    tags0 = [
        torch.cat([state_to_groups(sts[i].tags, groups) for sts in states]).contiguous()
        for i in range(len(levels))
    ]
    age0 = [
        torch.cat([state_to_groups(sts[i].age, groups) for sts in states]).contiguous()
        for i in range(len(levels))
    ]
    lvl, tags1, age1 = fused_levels(kept, offsets, levels, tags0, age0)
    lvl = lvl.cpu().numpy()
    outs, base = [], 0
    for s, (k, order, keep, _) in zip(streams, grouped):
        outs.append(_unpack_levels(len(s), lvl[base : base + len(k)], order, keep))
        base += len(k)
    if not return_states:
        return outs, None
    finals = []
    for j in range(len(streams)):
        rows = slice(j * groups, (j + 1) * groups)
        finals.append([
            canonicalize_state(
                state_from_groups(tags1[i][rows], sets, ways),
                state_from_groups(age1[i][rows], sets, ways),
            )
            for i, (sets, ways) in enumerate(levels)
        ])
    return outs, finals


def fused_cache_pass(
    blocks: np.ndarray,
    levels: Sequence[Tuple[int, int]],
    states: Optional[Sequence[CacheState]] = None,
    return_states: bool = False,
    device: DeviceLike = None,
):
    """Run a stream through a fused K-level hierarchy in one pass.

    Returns the per-access **hit level** (int8: ``i`` = hit at
    ``levels[i]``, ``len(levels)`` = missed everywhere) and, with
    ``return_states=True``, the canonical per-level :class:`CacheState`
    carries, resumable by this or any per-level engine bit-identically.
    """
    dev = resolve_device(device)
    levels = tuple((int(s), int(w)) for s, w in levels)
    sts = _resolve_states(levels, states, dev)
    blocks = _block_array(blocks)
    if len(blocks) == 0:
        lvl = np.zeros(0, dtype=np.int8)
        if not return_states:
            return lvl
        return lvl, [CacheState(st.tags.clone(), st.age.clone()) for st in sts]
    if dev.type == "cpu":
        groups = fused_group_count(levels)
        counts = _group_collapse(blocks, groups)[3]
        if _skewed_padded(counts, groups, len(blocks)):
            return _fused_fallback(blocks, levels, sts, return_states, dev)
    outs, finals = _fused_family([blocks], levels, [sts], dev, return_states)
    return (outs[0], finals[0]) if return_states else outs[0]


def fused_cache_pass_batch(
    streams: Sequence[np.ndarray],
    levels: Sequence[Tuple[int, int]],
    states: Optional[Sequence[Sequence[CacheState]]] = None,
    return_states: bool = False,
    device: DeviceLike = None,
):
    """Batched fused pass over same-geometry streams: one K2 launch.

    Returns one hit-level array per stream, bit-identical to looping
    :func:`fused_cache_pass`, plus per-stream canonical state lists with
    ``return_states=True``.  On a CPU device, set-skewed members (and an
    empty family) loop :func:`fused_cache_pass` instead.
    """
    dev = resolve_device(device)
    levels = tuple((int(s), int(w)) for s, w in levels)
    n = len(streams)
    streams = [_block_array(s) for s in streams]
    sts = [
        _resolve_states(levels, None if states is None else states[i], dev)
        for i in range(n)
    ]
    groups = fused_group_count(levels)
    if n == 0 or (
        dev.type == "cpu"
        and any(
            _skewed_padded(_group_collapse(s, groups)[3], groups, len(s))
            for s in streams
        )
    ):
        res = [fused_cache_pass(s, levels, st, return_states, dev) for s, st in zip(streams, sts)]
        if not return_states:
            return res
        return [r[0] for r in res], [r[1] for r in res]
    outs, finals = _fused_family(streams, levels, sts, dev, return_states)
    return (outs, finals) if return_states else outs


def levels_to_hits(lvl: np.ndarray, k: int):
    """Unpack a hit-level array into the per-level hit masks of the
    cascaded path: mask ``i`` covers the miss substream of level ``i-1``
    (the full stream for ``i = 0``)."""
    masks = []
    sub = np.asarray(lvl)
    for i in range(k):
        hit = sub == i
        masks.append(hit)
        sub = sub[~hit]
    return masks


__all__ = [
    "fused_cache_pass",
    "fused_cache_pass_batch",
    "fused_group_count",
    "levels_to_hits",
    "state_from_groups",
    "state_to_groups",
]
