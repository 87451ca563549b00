"""Hierarchy orchestration: shared demand profile + per-prefetcher runs.

Logical time convention: every event carries a position on the *full* access
trace; merged demand/prefetch ordering doubles positions so a prefetch
triggered by access ``p`` lands at ``2p+1`` — after its trigger, before the
next demand access at ``2(p+1)``.

All per-event output arrays are kept so metrics can be evaluated over a
position window (``eval_from_pos``): the paper evaluates BFS/BellmanFord on
the *second* (post-graph-change) run only, with caches warm from run 1.

Cache passes run on the device the caller names (``device=``, default the
CUDA card); a :class:`DemandProfile` remembers its device, so scoring
against it runs there too.  Per-event arrays stay numpy on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.memsim.config import HierarchyConfig
from repro_torch.memsim.engine import (
    CacheState,
    cache_pass,
    cache_pass_batch,
    current_engine,
    init_state,
)
from repro_torch.memsim.fused import fused_cache_pass, fused_cache_pass_batch
from repro_torch.memsim.scan_cache import classify_prefetch_events


def _demand_levels(cfg: HierarchyConfig):
    return (
        (cfg.l1.sets, cfg.l1.ways),
        (cfg.l2.sets, cfg.l2.ways),
        (cfg.llc.sets, cfg.llc.ways),
    )


@dataclasses.dataclass
class DemandProfile:
    """Baseline (no-prefetch) simulation of one full trace."""

    blocks: np.ndarray  # full trace line ids
    iter_id: np.ndarray  # full trace iteration (epoch) ids
    l1_hit: np.ndarray  # (N,) bool
    # L1-miss substream (these are the L2 accesses):
    l2_pos: np.ndarray  # positions into the full trace
    l2_blocks: np.ndarray
    l2_iter: np.ndarray
    l2_hit: np.ndarray  # baseline L2 hit mask over substream
    llc_hit: np.ndarray  # baseline LLC hit mask over the L2-miss substream
    cfg: HierarchyConfig
    device: torch.device  # where its cache passes ran; scoring follows it

    @property
    def num_accesses(self) -> int:
        return len(self.blocks)

    @property
    def l2_miss_pos(self) -> np.ndarray:
        return self.l2_pos[~self.l2_hit]

    @property
    def l2_miss_blocks(self) -> np.ndarray:
        return self.l2_blocks[~self.l2_hit]

    @property
    def l2_miss_iter(self) -> np.ndarray:
        return self.l2_iter[~self.l2_hit]

    def baseline_counts(self, from_pos: int = 0) -> dict:
        # l2_pos / l2_miss_pos are sorted, so window counts are searchsorteds.
        i_l2 = int(np.searchsorted(self.l2_pos, from_pos))
        mp = self.l2_miss_pos
        i_llc = int(np.searchsorted(mp, from_pos))
        dram = int((~self.llc_hit[i_llc:]).sum())
        return dict(
            accesses=self.num_accesses - from_pos,
            l1_miss=len(self.l2_pos) - i_l2,
            l2_miss=int((~self.l2_hit[i_l2:]).sum()),
            llc_miss=dram,
            dram=dram,
        )


@dataclasses.dataclass
class DemandState:
    """Carried hierarchy state for chunked (sharded) demand simulation.

    Bundles the canonical per-level :class:`CacheState` carries plus the
    global position of the next access, so a sequence of
    :func:`simulate_demand` calls over trace chunks produces profiles whose
    concatenation is bit-identical to one whole-trace call — the shard-seam
    contract the streaming scorer builds on.
    """

    l1: CacheState
    l2: CacheState
    llc: CacheState
    pos_offset: int = 0


def demand_init_state(cfg: HierarchyConfig, device: DeviceLike = None) -> DemandState:
    """Cold-cache carry (equivalent to passing ``state=None``)."""
    dev = resolve_device(device)
    return DemandState(
        l1=init_state(cfg.l1.sets, cfg.l1.ways, dev),
        l2=init_state(cfg.l2.sets, cfg.l2.ways, dev),
        llc=init_state(cfg.llc.sets, cfg.llc.ways, dev),
        pos_offset=0,
    )


def simulate_demand(
    blocks: np.ndarray,
    iter_id: np.ndarray,
    cfg: HierarchyConfig,
    state: DemandState | None = None,
    return_state: bool = False,
    device: DeviceLike = None,
):
    """Baseline demand simulation; optionally resuming from / yielding a
    :class:`DemandState` carry for chunked traces.  With a carry, ``l2_pos``
    is expressed in *global* trace positions (``state.pos_offset`` +
    chunk-local index), keeping windowed metrics chunk-invariant."""
    dev = resolve_device(device)
    offset = 0
    if state is not None:
        offset = state.pos_offset
    if current_engine() == "fused":
        return _simulate_demand_fused(blocks, iter_id, cfg, state, return_state, dev)
    l1_hit = cache_pass(
        blocks,
        cfg.l1.sets,
        cfg.l1.ways,
        state=state.l1 if state is not None else None,
        return_state=return_state,
        device=dev,
    )
    if return_state:
        l1_hit, l1_state = l1_hit
    l2_pos = np.flatnonzero(~l1_hit).astype(np.int64) + offset
    l2_blocks = blocks[l2_pos - offset]
    l2_iter = iter_id[l2_pos - offset]
    l2_hit = cache_pass(
        l2_blocks,
        cfg.l2.sets,
        cfg.l2.ways,
        state=state.l2 if state is not None else None,
        return_state=return_state,
        device=dev,
    )
    if return_state:
        l2_hit, l2_state = l2_hit
    llc_in = l2_blocks[~l2_hit]
    llc_hit = cache_pass(
        llc_in,
        cfg.llc.sets,
        cfg.llc.ways,
        state=state.llc if state is not None else None,
        return_state=return_state,
        device=dev,
    )
    if return_state:
        llc_hit, llc_state = llc_hit
    profile = DemandProfile(
        blocks=blocks,
        iter_id=iter_id,
        l1_hit=l1_hit,
        l2_pos=l2_pos,
        l2_blocks=l2_blocks,
        l2_iter=l2_iter,
        l2_hit=l2_hit,
        llc_hit=llc_hit,
        cfg=cfg,
        device=dev,
    )
    if not return_state:
        return profile
    next_state = DemandState(
        l1=l1_state, l2=l2_state, llc=llc_state, pos_offset=offset + len(blocks)
    )
    return profile, next_state


def _profile_from_levels(
    blocks: np.ndarray,
    iter_id: np.ndarray,
    cfg: HierarchyConfig,
    lvl: np.ndarray,
    offset: int,
    device: torch.device,
) -> DemandProfile:
    """Unpack a fused pass's hit-level array (0=L1 hit, 1=L2, 2=LLC,
    3=DRAM) into the cascaded per-level masks of :class:`DemandProfile` —
    each level's mask covers exactly the miss substream of the level
    above, identical to the per-level path by set independence."""
    l1_hit = lvl == 0
    l2_pos = np.flatnonzero(~l1_hit).astype(np.int64) + offset
    l2_lvl = lvl[~l1_hit]
    l2_hit = l2_lvl == 1
    return DemandProfile(
        blocks=blocks,
        iter_id=iter_id,
        l1_hit=l1_hit,
        l2_pos=l2_pos,
        l2_blocks=blocks[l2_pos - offset],
        l2_iter=iter_id[l2_pos - offset],
        l2_hit=l2_hit,
        llc_hit=l2_lvl[~l2_hit] == 2,
        cfg=cfg,
        device=device,
    )


def _simulate_demand_fused(
    blocks: np.ndarray,
    iter_id: np.ndarray,
    cfg: HierarchyConfig,
    state: DemandState | None,
    return_state: bool,
    device: torch.device,
):
    """One carried L1→L2→LLC pass (kernel K2) instead of three passes with
    host-side miss compaction between them (the ``fused`` engine's demand
    path)."""
    offset = state.pos_offset if state is not None else 0
    states = [state.l1, state.l2, state.llc] if state is not None else None
    res = fused_cache_pass(
        blocks, _demand_levels(cfg), states, return_states=return_state,
        device=device,
    )
    lvl = res[0] if return_state else res
    profile = _profile_from_levels(blocks, iter_id, cfg, lvl, offset, device)
    if not return_state:
        return profile
    l1_state, l2_state, llc_state = res[1]
    return profile, DemandState(
        l1=l1_state, l2=l2_state, llc=llc_state, pos_offset=offset + len(blocks)
    )


def simulate_demand_batch(
    items: list,
    cfg: HierarchyConfig,
    device: DeviceLike = None,
) -> list:
    """Demand-simulate same-hierarchy traces as one batched dispatch.

    ``items`` is a list of ``(blocks, iter_id)`` pairs (e.g. the seed
    replicas of one bench cell).  Under the ``fused`` engine the traces
    run as one K2 launch with a stream axis; other engines loop
    :func:`simulate_demand`.  Results are bit-identical either way.
    """
    dev = resolve_device(device)
    if current_engine() != "fused":
        return [simulate_demand(b, it, cfg, device=dev) for b, it in items]
    lvls = fused_cache_pass_batch(
        [b for b, _ in items], _demand_levels(cfg), device=dev
    )
    return [
        _profile_from_levels(b, it, cfg, lvl, 0, dev)
        for (b, it), lvl in zip(items, lvls)
    ]


@dataclasses.dataclass
class PrefetchOutcome:
    """Per-prefetcher simulation result over one trace (per-event arrays)."""

    pf_pos: np.ndarray  # issue positions (full-trace units)
    pf_issuer: np.ndarray  # (n_pf,) int8 issuer id (composite prefetching)
    pf_redundant: np.ndarray  # (n_pf,) bool: block already resident
    pf_no_future: np.ndarray  # (n_pf,) bool: never demanded after issue
    pf_llc_in_dram: np.ndarray  # over pf L2-misses: went to DRAM
    pf_llc_in_pos: np.ndarray  # their positions
    demand_l2_hit: np.ndarray  # (n_demand,) with prefetcher
    demand_useful: np.ndarray  # (n_demand,) demand hit on pf line
    demand_late: np.ndarray  # (n_demand,) useful but still in flight
    demand_fill_issuer: np.ndarray  # (n_demand,) issuer of the useful fill, -1
    demand_llc_hit: np.ndarray  # over demand L2 misses (with prefetcher)
    evicted_early_total: int
    pf_early: np.ndarray  # (n_pf,) prefetch fill evicted before reuse
    metadata_bytes: int = 0
    # LLC-input stream (only with ``keep_llc_stream=True``): the exact
    # event sequence the private LLC pass consumed, in simulation order —
    # block ids, doubled positions (2p demand / 2p+1 prefetch), and the
    # is-prefetch flag.  The multi-tenant serving layer re-plays these
    # events through one *shared* LLC (repro_torch.memsim.shared_llc) and patches
    # ``demand_llc_hit``/``pf_llc_in_dram`` with the contended hit masks.
    # Default None keeps artifact round-trips and pickling unchanged.
    llc_in_blocks: np.ndarray | None = None
    llc_in_pos2: np.ndarray | None = None
    llc_in_is_pf: np.ndarray | None = None

    @property
    def issued(self) -> int:
        return len(self.pf_pos)


def simulate_with_prefetch(
    profile: DemandProfile,
    pf_blocks: np.ndarray,
    pf_pos: np.ndarray,
    pf_issuer: np.ndarray | None = None,
    metadata_bytes: int = 0,
    keep_llc_stream: bool = False,
) -> PrefetchOutcome:
    """Re-simulate L2+LLC with a (possibly multi-issuer) prefetch stream.

    ``keep_llc_stream=True`` additionally stashes the LLC-input event
    stream (blocks, doubled positions, is-prefetch flags) on the outcome
    so a shared-LLC pass can re-simulate it under multi-tenant contention.
    """
    cfg = profile.cfg
    nd = len(profile.l2_blocks)
    npf = len(pf_blocks)
    if npf == 0:
        d_miss = ~profile.l2_hit
        return PrefetchOutcome(
            pf_pos=np.zeros(0, dtype=np.int64),
            pf_issuer=np.zeros(0, dtype=np.int8),
            pf_redundant=np.zeros(0, dtype=bool),
            pf_no_future=np.zeros(0, dtype=bool),
            pf_llc_in_dram=np.zeros(0, dtype=bool),
            pf_llc_in_pos=np.zeros(0, dtype=np.int64),
            demand_l2_hit=profile.l2_hit.copy(),
            demand_useful=np.zeros(nd, dtype=bool),
            demand_late=np.zeros(nd, dtype=bool),
            demand_fill_issuer=np.full(nd, -1, dtype=np.int8),
            demand_llc_hit=profile.llc_hit.copy(),
            evicted_early_total=0,
            pf_early=np.zeros(0, dtype=bool),
            metadata_bytes=metadata_bytes,
            llc_in_blocks=profile.l2_blocks[d_miss] if keep_llc_stream else None,
            llc_in_pos2=2 * profile.l2_pos[d_miss] if keep_llc_stream else None,
            llc_in_is_pf=np.zeros(int(d_miss.sum()), dtype=bool)
            if keep_llc_stream
            else None,
        )

    merged = _merge_prefetch_stream(profile, pf_blocks, pf_pos, pf_issuer)
    mblocks_s = merged["mblocks_s"]
    # Scoring a single stream runs the per-level cascade under every
    # engine (the L2 substream has no L1-filterable runs to collapse); the
    # fused engine's scoring win is batching, see
    # simulate_with_prefetch_batch.
    hit = cache_pass(mblocks_s, cfg.l2.sets, cfg.l2.ways, device=profile.device)
    # LLC sees every L2 miss (demand or prefetch) in order.
    llc_hit = cache_pass(
        mblocks_s[~hit], cfg.llc.sets, cfg.llc.ways, device=profile.device
    )
    return _finish_prefetch_outcome(
        profile, merged, hit, llc_hit, metadata_bytes, keep_llc_stream
    )


def simulate_with_prefetch_batch(
    profile: DemandProfile,
    streams: list,
    metadata_bytes: list | None = None,
    keep_llc_stream: bool = False,
) -> list:
    """Score several prefetch streams against one profile in one dispatch.

    ``streams`` is a list of ``(pf_blocks, pf_pos, pf_issuer)`` triples
    (``pf_issuer`` may be None) — typically one per prefetcher family of a
    workload.  Under the ``fused`` engine the merged L2 streams run as one
    K1 launch per level with a stream axis
    (:func:`repro_torch.memsim.engine.cache_pass_batch`) — the family's
    ``2 × n_prefetchers`` scoring launches collapse to two; other engines
    (and empty streams) loop :func:`simulate_with_prefetch`.  Outcomes
    are bit-identical to the loop either way.
    """
    meta = metadata_bytes if metadata_bytes is not None else [0] * len(streams)
    if current_engine() != "fused" or any(len(s[0]) == 0 for s in streams):
        return [
            simulate_with_prefetch(
                profile, b, p, issuer, m, keep_llc_stream=keep_llc_stream
            )
            for (b, p, issuer), m in zip(streams, meta)
        ]
    cfg = profile.cfg
    merged = [
        _merge_prefetch_stream(profile, b, p, issuer) for b, p, issuer in streams
    ]
    l2_hits = cache_pass_batch(
        [m["mblocks_s"] for m in merged], cfg.l2.sets, cfg.l2.ways,
        device=profile.device,
    )
    llc_hits = cache_pass_batch(
        [m["mblocks_s"][~h] for m, h in zip(merged, l2_hits)],
        cfg.llc.sets,
        cfg.llc.ways,
        device=profile.device,
    )
    return [
        _finish_prefetch_outcome(profile, m, h, lh, mb, keep_llc_stream)
        for m, h, lh, mb in zip(merged, l2_hits, llc_hits, meta)
    ]


def _merge_prefetch_stream(
    profile: DemandProfile,
    pf_blocks: np.ndarray,
    pf_pos: np.ndarray,
    pf_issuer: np.ndarray | None,
) -> dict:
    """Interleave a prefetch stream into the demand L2 substream.

    Demand events land at doubled positions ``2p``, prefetches at
    ``2p+1``.  Both substreams are position-sorted, so the merge is a
    single searchsorted instead of a full argsort of the concatenation.
    """
    nd = len(profile.l2_blocks)
    npf = len(pf_blocks)
    pf_blocks = np.asarray(pf_blocks, dtype=np.int64)
    pf_pos = np.asarray(pf_pos, dtype=np.int64)
    if pf_issuer is None:
        pf_issuer = np.zeros(npf, dtype=np.int8)
    pf_issuer = np.asarray(pf_issuer, dtype=np.int8)
    if npf > 1 and np.any(pf_pos[1:] < pf_pos[:-1]):
        o = np.argsort(pf_pos, kind="stable")
        pf_pos, pf_blocks, pf_issuer = pf_pos[o], pf_blocks[o], pf_issuer[o]

    total = nd + npf
    pf_slots = np.searchsorted(2 * profile.l2_pos, 2 * pf_pos + 1) + np.arange(npf)
    demand_slots = np.ones(total, dtype=bool)
    demand_slots[pf_slots] = False
    demand_slots = np.flatnonzero(demand_slots)
    mpos_s = np.empty(total, dtype=np.int64)
    mblocks_s = np.empty(total, dtype=np.int64)
    m_is_pf_s = np.zeros(total, dtype=bool)
    mpos_s[demand_slots] = 2 * profile.l2_pos
    mpos_s[pf_slots] = 2 * pf_pos + 1
    mblocks_s[demand_slots] = profile.l2_blocks
    mblocks_s[pf_slots] = pf_blocks
    m_is_pf_s[pf_slots] = True

    m_issuer = np.full(total, -1, dtype=np.int8)
    m_issuer[pf_slots] = pf_issuer
    return dict(
        pf_blocks=pf_blocks,
        pf_pos=pf_pos,
        pf_issuer=pf_issuer,
        pf_slots=pf_slots,
        demand_slots=demand_slots,
        mpos_s=mpos_s,
        mblocks_s=mblocks_s,
        m_is_pf_s=m_is_pf_s,
        m_issuer=m_issuer,
    )


def _finish_prefetch_outcome(
    profile: DemandProfile,
    merged: dict,
    hit: np.ndarray,
    llc_hit: np.ndarray,
    metadata_bytes: int,
    keep_llc_stream: bool,
) -> PrefetchOutcome:
    """Classify + unmerge one scored stream back into a
    :class:`PrefetchOutcome` (``hit`` over the merged stream, ``llc_hit``
    over its L2-miss substream — however the passes were dispatched)."""
    cfg = profile.cfg
    mblocks_s = merged["mblocks_s"]
    mpos_s = merged["mpos_s"]
    m_is_pf_s = merged["m_is_pf_s"]
    pf_slots = merged["pf_slots"]
    demand_slots = merged["demand_slots"]
    pf_blocks, pf_pos = merged["pf_blocks"], merged["pf_pos"]

    useful, late, redundant, early, fill_origin = classify_prefetch_events(
        mblocks_s, m_is_pf_s, mpos_s, hit, 2 * cfg.pf_fill_window
    )
    llc_sel = ~hit
    llc_is_pf = m_is_pf_s[llc_sel]
    llc_pos = mpos_s[llc_sel] // 2

    # Unmerge.
    demand_l2_hit = hit[demand_slots]
    demand_useful = useful[demand_slots]
    demand_late = late[demand_slots]
    pf_redundant = redundant[pf_slots]
    pf_early = early[pf_slots]
    d_fill = fill_origin[demand_slots]
    demand_fill_issuer = np.where(
        d_fill >= 0, merged["m_issuer"][np.maximum(d_fill, 0)], -1
    ).astype(np.int8)

    # Demand LLC hits over demand L2 misses, in demand order: the demand
    # events within the LLC stream appear in merged order == pos order,
    # which equals demand-substream order (stable sort on pos).
    demand_llc_hit = llc_hit[~llc_is_pf]

    pf_no_future = _no_future_demand(
        pf_blocks, pf_pos, profile.l2_miss_blocks, profile.l2_miss_pos
    )

    return PrefetchOutcome(
        pf_pos=pf_pos,
        pf_issuer=merged["pf_issuer"],
        pf_redundant=pf_redundant,
        pf_no_future=pf_no_future,
        pf_llc_in_dram=(~llc_hit)[llc_is_pf],
        pf_llc_in_pos=llc_pos[llc_is_pf],
        demand_l2_hit=demand_l2_hit,
        demand_useful=demand_useful,
        demand_late=demand_late,
        demand_fill_issuer=demand_fill_issuer,
        demand_llc_hit=demand_llc_hit,
        evicted_early_total=int(early.sum()),
        pf_early=pf_early,
        metadata_bytes=metadata_bytes,
        llc_in_blocks=mblocks_s[llc_sel] if keep_llc_stream else None,
        llc_in_pos2=mpos_s[llc_sel] if keep_llc_stream else None,
        llc_in_is_pf=llc_is_pf if keep_llc_stream else None,
    )


def _no_future_demand(
    pf_blocks: np.ndarray,
    pf_pos: np.ndarray,
    demand_blocks: np.ndarray,
    demand_pos: np.ndarray,
) -> np.ndarray:
    """Per-prefetch flag: block never appears in future baseline L2 misses."""
    if len(pf_blocks) == 0:
        return np.zeros(0, dtype=bool)
    if len(demand_blocks) == 0:
        return np.ones(len(pf_blocks), dtype=bool)
    dkey_sort = (demand_blocks.astype(np.int64) << np.int64(31)) | demand_pos
    order = np.argsort(dkey_sort)
    db = demand_blocks[order]
    dp = demand_pos[order]
    BIG = np.int64(1) << 40
    dkey = db.astype(np.int64) * BIG + dp
    pkey = pf_blocks.astype(np.int64) * BIG + pf_pos
    idx = np.searchsorted(dkey, pkey, side="right")
    safe = np.minimum(idx, len(db) - 1)
    has_future = (idx < len(dkey)) & (db[safe] == pf_blocks)
    return ~has_future
