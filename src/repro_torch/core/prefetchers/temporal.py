"""Temporal baselines: ISB, MISB (PC-localized), Domino (pair-correlated).

Predictions are *epoch-causal*: epoch k uses streams recorded in epoch k-1.
A high-water-mark dedupe models the hardware stream pointer: while the
pattern is followed, each trigger issues only the not-yet-issued tail of its
degree window (otherwise temporal prefetchers would re-issue the whole
window on every trigger).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.amc.prefetcher import PrefetchStream
from repro_torch.core.registry import register_prefetcher


def _first_occurrence_index(stream: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """sorted unique blocks + index of their first occurrence in stream."""
    uniq, first = np.unique(stream, return_index=True)
    return uniq, first


def _issue_with_hwm(trig_idx: np.ndarray, degree: int, stream_len: int):
    """Per-trigger issue ranges [lo, hi] with a cummax high-water mark."""
    hi = np.minimum(trig_idx + degree, stream_len - 1)
    hwm = np.concatenate([[-1], np.maximum.accumulate(hi)[:-1]])
    lo = np.maximum(trig_idx + 1, hwm + 1)
    counts = np.maximum(hi - lo + 1, 0)
    return lo, counts


def _expand(lo: np.ndarray, counts: np.ndarray) -> np.ndarray:
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.zeros(len(counts), dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    return np.repeat(lo, counts) + (
        np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    )


def _pc_groups(blk: np.ndarray, pos: np.ndarray, pcs: np.ndarray):
    """Per-PC substreams via one stable argsort group-by: yields
    ``(pc, stream, spos)`` in ascending-PC order, stream order preserved
    within each PC.  Replaces the O(PCs x N) per-PC boolean masks."""
    order = np.argsort(pcs, kind="stable")
    pc_s = pcs[order]
    starts = np.flatnonzero(np.diff(pc_s, prepend=pc_s[:1] - 1))
    bounds = np.append(starts, len(pc_s))
    blk_s, pos_s = blk[order], pos[order]
    for i, g0 in enumerate(starts):
        g1 = bounds[i + 1]
        yield int(pc_s[g0]), blk_s[g0:g1], pos_s[g0:g1]


def _temporal_stream(workload, degree: int, localize_pc: bool, train_once: bool):
    """Shared ISB/MISB machinery. Returns pf arrays + op counts.

    ``train_once=True`` models ISB/MISB's append-only structural address
    space: first-touch assignment in the initial epoch is never remapped
    (the paper: "inability to delete useless metadata"), so predictions in
    later epochs replay initial-epoch successor chains — the mechanism that
    breaks on evolving graphs.

    Every PC's structural space is assigned in the first epoch (a PC with
    no first-epoch misses gets an empty stream), so under ``train_once``
    only first-epoch streams are ever trained and ``prev`` stays frozen —
    exactly the dict-carrying semantics of the original per-(epoch, PC)
    mask implementation, now via one group-by sort per epoch.
    """
    pos, blocks, pcs, epochs = workload.l2_stream()
    miss = ~workload.nl_outcome.demand_l2_hit  # trigger & train on L2 misses
    mpos, mblk, mpc, mep = pos[miss], blocks[miss], pcs[miss], epochs[miss]

    out_b, out_p = [], []
    n_lookups = 0
    n_train = 0
    # The miss stream is position-sorted and epoch ids are nondecreasing
    # along the trace, so epochs are contiguous runs: slice by boundaries.
    uniq_eps = np.unique(mep)
    e_bounds = np.searchsorted(mep, uniq_eps)
    e_bounds = np.append(e_bounds, len(mep))
    # previous epoch's per-pc streams (frozen first-epoch ones if train_once)
    prev: Dict[int, tuple] = {}
    empty = (np.zeros(0, mblk.dtype), np.zeros(0, mpos.dtype))
    for ei in range(len(uniq_eps)):
        e0, e1 = e_bounds[ei], e_bounds[ei + 1]
        blk_e, pos_e = mblk[e0:e1], mpos[e0:e1]
        if localize_pc:
            groups = _pc_groups(blk_e, pos_e, mpc[e0:e1])
        else:
            groups = [(0, blk_e, pos_e)]
        first_epoch = ei == 0
        cur: Dict[int, tuple] = dict(prev) if train_once and not first_epoch else {}
        for pc, stream, spos in groups:
            if not (train_once and not first_epoch):
                cur[pc] = (stream, spos)
                n_train += len(stream)
            if first_epoch:
                continue
            tstream, _ = prev.get(pc, empty)
            if len(tstream) < 2 or len(stream) == 0:
                continue
            uniq, first = _first_occurrence_index(tstream)
            li = np.searchsorted(uniq, stream)
            ok = (li < len(uniq)) & (uniq[np.minimum(li, len(uniq) - 1)] == stream)
            n_lookups += len(stream)
            tidx = first[np.minimum(li, len(uniq) - 1)]
            tidx = tidx[ok]
            tpos = spos[ok]
            if len(tidx) == 0:
                continue
            lo, counts = _issue_with_hwm(tidx, degree, len(tstream))
            sidx = _expand(lo, counts)
            out_b.append(tstream[sidx])
            out_p.append(np.repeat(tpos, counts))
        prev = cur
    blocks_out = np.concatenate(out_b) if out_b else np.zeros(0, np.int64)
    pos_out = np.concatenate(out_p) if out_p else np.zeros(0, np.int64)
    return blocks_out, pos_out, n_train, n_lookups


@register_prefetcher(
    "isb",
    trains_on="l2_miss",
    storage="off-chip PS/SP maps, TLB-synced 64B transfers",
    family="temporal",
)
def isb(workload) -> PrefetchStream:
    """ISB [23]: PC-localized structural temporal streams, degree 32.

    Metadata: PS & SP mappings (8B each) touched on every training update
    and lookup; ISB's TLB-sync forces full-line (64B) off-chip metadata
    transfers per lookup — the paper measures ~5x demand traffic."""
    b, p, n_train, n_lookups = _temporal_stream(
        workload, degree=32, localize_pc=True, train_once=True
    )
    meta = n_train * 16 + n_lookups * 64 + len(b) * 8
    return PrefetchStream("isb", b, p, metadata_bytes=meta)


@register_prefetcher(
    "misb",
    trains_on="l2_miss",
    storage="off-chip 8B mappings + on-chip bloom filter",
    family="temporal",
)
def misb(workload) -> PrefetchStream:
    """MISB [67]: same correlations, metadata managed with 8B mappings +
    bloom filter (most useless lookups filtered on-chip)."""
    b, p, n_train, n_lookups = _temporal_stream(
        workload, degree=32, localize_pc=True, train_once=True
    )
    meta = n_train * 8 + int(n_lookups * 0.25) * 8 + len(b)
    return PrefetchStream("misb", b, p, metadata_bytes=meta)


@register_prefetcher(
    "domino",
    trains_on="l2_miss",
    storage="off-chip miss-pair history",
    family="temporal",
)
def domino(workload) -> PrefetchStream:
    """Domino [5]: global miss-pair -> next-miss stream, degree 4."""
    pos, blocks, _, epochs = workload.l2_stream()
    miss = ~workload.nl_outcome.demand_l2_hit
    mpos, mblk, mep = pos[miss], blocks[miss], epochs[miss]
    out_b, out_p = [], []
    n_train = 0
    prev = None
    for e in np.unique(mep):
        s = mep == e
        stream, spos = mblk[s], mpos[s]
        n_train += len(stream)
        if prev is not None and len(prev) > 2 and len(stream) > 1:
            tstream = prev
            # pair keys of the trained stream
            pair = (tstream[:-1].astype(np.int64) << np.int64(25)) ^ tstream[1:]
            order = np.argsort(pair, kind="stable")
            psort = pair[order]
            cur_pair = (stream[:-1].astype(np.int64) << np.int64(25)) ^ stream[1:]
            li = np.searchsorted(psort, cur_pair)
            ok = (li < len(psort)) & (psort[np.minimum(li, len(psort) - 1)] == cur_pair)
            tidx = order[np.minimum(li, len(psort) - 1)] + 1  # index of 2nd elem
            tidx, tpos = tidx[ok], spos[1:][ok]
            if len(tidx):
                lo, counts = _issue_with_hwm(tidx, 4, len(tstream))
                sidx = _expand(lo, counts)
                out_b.append(tstream[sidx])
                out_p.append(np.repeat(tpos, counts))
        prev = stream
    b = np.concatenate(out_b) if out_b else np.zeros(0, np.int64)
    p = np.concatenate(out_p) if out_p else np.zeros(0, np.int64)
    return PrefetchStream("domino", b, p, metadata_bytes=n_train * 12)
