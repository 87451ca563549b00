"""Spatial baselines: VLDP (cascaded delta tables) and Bingo (footprints).

Both learn within-page patterns. Tables are trained on the previous epoch's
L2 access stream (epoch-causal, like the temporal baselines); triggers are
composite-baseline L2 misses.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.amc.prefetcher import PrefetchStream
from repro_torch.core.registry import register_prefetcher

PAGE_BLOCKS = 64  # 4KB page / 64B line


def _page_off(blocks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return blocks >> 6, blocks & 63


def _majority_table(keys: np.ndarray, nexts: np.ndarray):
    """key -> most frequent next value. Returns (sorted_keys, best_next)."""
    if len(keys) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.lexsort((nexts, keys))
    k, nx = keys[order], nexts[order]
    # count runs of (key, next)
    new_pair = np.ones(len(k), dtype=bool)
    new_pair[1:] = (k[1:] != k[:-1]) | (nx[1:] != nx[:-1])
    pair_start = np.flatnonzero(new_pair)
    pair_count = np.diff(np.append(pair_start, len(k)))
    pk, pn = k[pair_start], nx[pair_start]
    # per key pick the max-count pair
    new_key = np.ones(len(pk), dtype=bool)
    new_key[1:] = pk[1:] != pk[:-1]
    key_id = np.cumsum(new_key) - 1
    best = np.full(key_id[-1] + 1, -1, dtype=np.int64)
    best_cnt = np.zeros(key_id[-1] + 1, dtype=np.int64)
    np.maximum.at(best_cnt, key_id, pair_count)
    take = pair_count == best_cnt[key_id]
    # later duplicates overwrite; deterministic enough for a majority table
    best[key_id[take]] = pn[take]
    return pk[np.flatnonzero(new_key)], best


def _lookup(sorted_keys: np.ndarray, values: np.ndarray, q: np.ndarray):
    if len(sorted_keys) == 0:
        return np.full(len(q), -(10**9), dtype=np.int64)
    li = np.searchsorted(sorted_keys, q)
    li_c = np.minimum(li, len(sorted_keys) - 1)
    ok = sorted_keys[li_c] == q
    return np.where(ok, values[li_c], -(10**9))


def _window_dedupe(blocks: np.ndarray, pos: np.ndarray, window: int) -> np.ndarray:
    """Keep an issue only if the previous issue of the same block is more
    than ``window`` accesses earlier (L2 residency horizon proxy). Returns a
    boolean keep-mask in the input order."""
    n = len(blocks)
    key = (blocks.astype(np.int64) << np.int64(31)) | np.maximum(pos, 0)
    order = np.argsort(key)
    b, p = blocks[order], pos[order]
    same = np.zeros(n, dtype=bool)
    same[1:] = b[1:] == b[:-1]
    gap_ok = np.ones(n, dtype=bool)
    gap_ok[1:] = (p[1:] - p[:-1]) > window
    keep_sorted = ~same | gap_ok
    keep = np.zeros(n, dtype=bool)
    keep[order] = keep_sorted
    return keep


def _page_deltas(blocks: np.ndarray, pos: np.ndarray):
    """Sort by (page, stream order); return per-access page, delta history."""
    page, off = _page_off(blocks)
    key = (page.astype(np.int64) << np.int64(31)) | np.arange(len(blocks))
    order = np.argsort(key)
    pg, of, po = page[order], off[order], pos[order]
    new_pg = np.ones(len(pg), dtype=bool)
    new_pg[1:] = pg[1:] != pg[:-1]
    d = np.zeros(len(pg), dtype=np.int64)
    d[1:] = of[1:] - of[:-1]
    d[new_pg] = 0  # no delta at page start
    valid = ~new_pg

    def hist(k):
        h = np.full(len(pg), -(10**8), dtype=np.int64)
        h[k:] = d[: len(pg) - k] if k else d
        # invalidate histories crossing page starts
        bad = np.zeros(len(pg), dtype=bool)
        for j in range(k + 1):
            b = np.zeros(len(pg), dtype=bool)
            b[j:] = new_pg[: len(pg) - j] if j else new_pg
            bad |= b
        h[bad] = -(10**8)
        return h

    return order, pg, of, po, d, valid, hist


_B = np.int64(1 << 14)  # delta packing radix (deltas in [-64, 63])


def _pack2(a, b):
    return (a + 64) * _B + (b + 64)


def _pack3(a, b, c):
    return ((a + 64) * _B + (b + 64)) * _B + (c + 64)


@register_prefetcher(
    "vldp",
    trains_on="l2_access",
    storage="on-chip cascaded delta tables",
    family="spatial",
)
def vldp(workload) -> PrefetchStream:
    """VLDP [51]: cascaded DPT1..3 + OPT, degree 4 (paper Table VIII).

    Prediction priority: longest delta-history match (DPT3 > DPT2 > DPT1 >
    OPT). Chaining beyond the first prediction follows DPT1. Storage is
    on-chip (~1KB) => no off-chip metadata traffic.
    """
    pos, blocks, _, epochs = workload.l2_stream()
    miss_mask = ~workload.nl_outcome.demand_l2_hit
    out_b, out_p = [], []
    tables: Optional[dict] = None
    for e in np.unique(epochs):
        s = epochs == e
        blk_e, pos_e, miss_e = blocks[s], pos[s], miss_mask[s]
        order, pg, of, po, d, valid, hist = _page_deltas(blk_e, pos_e)

        if tables is not None and len(blk_e):
            h1, h2, h3 = hist(1), hist(2), hist(3)
            # triggers: misses with at least one past delta in page
            mi = miss_e[order] & valid
            q1 = _lookup(tables["t1"][0], tables["t1"][1], d)
            q2 = _lookup(tables["t2"][0], tables["t2"][1], _pack2(h1, d))
            q3 = _lookup(tables["t3"][0], tables["t3"][1], _pack3(h2, h1, d))
            pred = np.where(q3 > -(10**8), q3, np.where(q2 > -(10**8), q2, q1))
            # OPT: first access in page predicts via first-offset table
            first = ~valid
            qo = _lookup(tables["opt"][0], tables["opt"][1], of)
            pred = np.where(first, qo, pred)
            mi = miss_e[order] & (pred > -(10**8))
            base_off = of
            cur_off = base_off
            cur_delta = pred
            ep_b, ep_p = [], []
            for step in range(4):
                nxt = cur_off + cur_delta
                ok = mi & (nxt >= 0) & (nxt < PAGE_BLOCKS) & (cur_delta > -(10**8))
                ep_b.append((pg[ok] << 6) | nxt[ok])
                ep_p.append(po[ok])
                if step < 3:
                    cur_off = np.where(ok, nxt, cur_off)
                    nd = _lookup(tables["t1"][0], tables["t1"][1], cur_delta)
                    cur_delta = nd
                    mi = ok
            # In-flight/residency filter: successive triggers walking the
            # same pattern re-predict the same lines; re-issue a block only
            # after its previous issue has likely aged out of L2.
            eb = np.concatenate(ep_b)
            ep = np.concatenate(ep_p)
            if len(eb):
                keep = _window_dedupe(eb, ep, window=1500)
                out_b.append(eb[keep])
                out_p.append(ep[keep])

        # train tables on this epoch for the next one
        h1, h2, h3 = hist(1), hist(2), hist(3)
        nxt_d = np.full(len(d), -(10**8), dtype=np.int64)
        nxt_d[:-1] = d[1:]
        same_pg = np.zeros(len(d), dtype=bool)
        same_pg[:-1] = pg[1:] == pg[:-1]
        tr = valid & same_pg & (nxt_d > -(10**8))
        t1 = _majority_table(d[tr], nxt_d[tr])
        tr2 = tr & (h1 > -(10**8))
        t2 = _majority_table(_pack2(h1[tr2], d[tr2]), nxt_d[tr2])
        tr3 = tr2 & (h2 > -(10**8))
        t3 = _majority_table(_pack3(h2[tr3], h1[tr3], d[tr3]), nxt_d[tr3])
        first = np.ones(len(d), dtype=bool)
        first[1:] = pg[1:] != pg[:-1]
        fo = first.copy()
        fo[:-1] &= same_pg[:-1]
        opt = _majority_table(of[first & same_pg], nxt_d[first & same_pg])
        tables = dict(t1=t1, t2=t2, t3=t3, opt=opt)

    b = np.concatenate(out_b) if out_b else np.zeros(0, np.int64)
    p = np.concatenate(out_p) if out_p else np.zeros(0, np.int64)
    return PrefetchStream("vldp", b, p, metadata_bytes=0)


@register_prefetcher(
    "bingo",
    trains_on="l2_access",
    storage="on-chip footprint history table",
    family="spatial",
)
def bingo(workload) -> PrefetchStream:
    """Bingo [6]: per-region footprint replay, 2KB regions, degree<=32.

    The trigger is the first miss in a region per epoch; the prediction is
    the footprint (set of blocks) the region exhibited in the previous
    epoch. 119KB on-chip history => no off-chip metadata."""
    REGION = 32  # blocks per 2KB region
    pos, blocks, _, epochs = workload.l2_stream()
    miss_mask = ~workload.nl_outcome.demand_l2_hit
    out_b, out_p = [], []
    prev_fp: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    for e in np.unique(epochs):
        s = epochs == e
        blk_e, pos_e, miss_e = blocks[s], pos[s], miss_mask[s]
        region = blk_e // REGION
        # Footprint = blocks touched within one generation (a window after
        # the region's first access), per Bingo's trigger->eviction history,
        # NOT the whole epoch's region traffic.
        if len(blk_e):
            order_r = np.argsort(region, kind="stable")
            rr, pp, bb = region[order_r], pos_e[order_r], blk_e[order_r]
            starts = np.ones(len(rr), dtype=bool)
            starts[1:] = rr[1:] != rr[:-1]
            start_idx = np.flatnonzero(starts)
            counts = np.diff(np.append(start_idx, len(rr)))
            region_first = np.repeat(pp[start_idx], counts)
            in_gen = pp <= region_first + 1500
            fp_keys = np.unique(
                rr[in_gen] * np.int64(1 << 26) + bb[in_gen]
            )
        else:
            fp_keys = np.zeros(0, np.int64)
        fp_region = fp_keys >> 26
        fp_block = fp_keys & ((1 << 26) - 1)
        if prev_fp is not None and len(blk_e):
            pr, pb, p_off = prev_fp
            # a region "generation" restarts once its blocks age out of L2;
            # the first miss of each generation triggers footprint replay
            mi = np.flatnonzero(miss_e)
            if len(mi):
                r_mi = region[mi]
                first_mask = _window_dedupe(r_mi, pos_e[mi], window=1500)
                trig = mi[first_mask]
                t_region = region[trig]
                lo = np.searchsorted(pr, t_region, side="left")
                hi = np.searchsorted(pr, t_region, side="right")
                counts = np.minimum(hi - lo, 32)
                tot = int(counts.sum())
                if tot:
                    starts = np.zeros(len(counts), dtype=np.int64)
                    np.cumsum(counts[:-1], out=starts[1:])
                    idx = np.repeat(lo, counts) + (
                        np.arange(tot) - np.repeat(starts, counts)
                    )
                    out_b.append(pb[idx])
                    out_p.append(np.repeat(pos_e[trig], counts))
        prev_fp = (fp_region, fp_block, None)
    b = np.concatenate(out_b) if out_b else np.zeros(0, np.int64)
    p = np.concatenate(out_p) if out_p else np.zeros(0, np.int64)
    return PrefetchStream("bingo", b, p, metadata_bytes=0)
