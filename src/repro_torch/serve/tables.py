"""Shared-AMC-table walk for multi-tenant serving (ported from
``repro.serve.tables``; host numpy, as in the JAX package).

``TableMode`` axis, shared side: K tenants' iteration views are merged
into the global interleaved order and driven through ONE
:class:`~repro_torch.core.amc.storage.AMCStorage` pair.  The walk is the body of
:meth:`AMCPrefetcher.generate` with three multi-tenant extensions:

- **Per-tenant epoch tracking.**  Each tenant's ``AMC.update()`` (epoch
  boundary in its own trace) triggers :meth:`AMCStorage.swap` on the
  *shared* spaces.  That is the naive-sharing semantic: one tenant's
  update invalidates everyone's freshly recorded tables — the paper's
  role-reversal applied to a resource it was never designed to share.

- **Ownership accounting.**  Recording tables are tagged with the tenant
  that wrote them.  A ``store()`` landing on a same-key table recorded by
  another tenant is a *cross-tenant overwrite* (its entries are counted as
  thrashed); a ``lookup()`` hit on a table recorded by another tenant is
  an *aliased hit* — the prefetcher replays a different query's miss
  stream, the serving-scale version of the paper's correlation-aliasing
  failure mode.  (PGD/CC put every iteration in its own epoch with
  ``within_epoch == 0``, so K such tenants contend for a single table
  key — aliasing is maximal by construction.)

- **Per-tenant traffic deltas.**  Metadata read/write/dropped counters are
  snapshotted around each view so every tenant's ``PrefetchStream.info``
  carries its own share, exactly as ``generate()`` reports per-call deltas.

With K=1 no extension fires (no foreign owner, deltas sum to the
call-total) and the walk is statement-for-statement ``generate()`` —
the byte-identity anchor asserted in ``tests/test_torch_serve.py``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.amc.compression import CompressionStats
from repro_torch.core.amc.prefetcher import AMCPrefetcher, PrefetchStream
from repro_torch.core.amc.storage import AMCStorage
from repro_torch.serve.interleave import Interleave


def _view_global_starts(trace, il_gmap: np.ndarray) -> np.ndarray:
    """Global slot of each iteration's first access in one tenant's trace."""
    n_iters = len(trace.iter_epochs)
    starts = np.searchsorted(trace.iter_id, np.arange(n_iters))
    # An empty trailing iteration would index one past the end; clamp —
    # its slot only orders the (no-op) view relative to other tenants.
    starts = np.minimum(starts, max(len(trace.iter_id) - 1, 0))
    return il_gmap[starts]


def shared_table_streams(
    prefetcher: AMCPrefetcher, traces: Sequence, il: Interleave
) -> Tuple[List[PrefetchStream], dict]:
    """Run the AMC lifecycle for K tenants over one shared table store.

    Returns one :class:`PrefetchStream` per tenant (blocks/pos in that
    tenant's private positions, info mirroring ``generate()``) plus a
    contention-counter dict with global totals and a ``per_tenant`` list.
    """
    cfg = prefetcher.config
    storage = AMCStorage(
        int(cfg.storage_fraction * sum(t.input_bytes for t in traces))
    )
    k_tenants = len(traces)

    # Merge all tenants' views into the interleaved global order.
    entries = []  # (gstart, tenant, view, epoch)
    for k, t in enumerate(traces):
        views = t.amc_iteration_views()
        if not views:
            continue
        gstarts = _view_global_starts(t, il.gmaps[k])
        for (view, epoch), g in zip(views, gstarts):
            entries.append((int(g), k, view, epoch))
    # Global slots are unique across tenants; stable sort keeps each
    # tenant's view order on (possible) within-tenant ties.
    order = np.argsort(
        np.asarray([e[0] for e in entries], dtype=np.int64), kind="stable"
    )

    cur_epoch: Dict[int, object] = {k: None for k in range(k_tenants)}
    rec_owner: Dict[int, int] = {}  # iteration key -> recording tenant
    pf_owner: Dict[int, int] = {}  # same, for the prefetch space
    stats = [CompressionStats() for _ in range(k_tenants)]
    out_blocks: List[List[np.ndarray]] = [[] for _ in range(k_tenants)]
    out_pos: List[List[np.ndarray]] = [[] for _ in range(k_tenants)]
    read_d = np.zeros(k_tenants, dtype=np.int64)
    write_d = np.zeros(k_tenants, dtype=np.int64)
    dropped_d = np.zeros(k_tenants, dtype=np.int64)
    lookups = np.zeros(k_tenants, dtype=np.int64)
    hits = np.zeros(k_tenants, dtype=np.int64)
    aliased = np.zeros(k_tenants, dtype=np.int64)
    evicted = np.zeros(k_tenants, dtype=np.int64)  # recordings clobbered
    swaps = 0
    cross_overwrites = 0
    thrashed_entries = 0

    for idx in order:
        _, k, view, epoch = entries[idx]
        if epoch != cur_epoch[k]:
            if cur_epoch[k] is not None:
                storage.swap()  # this tenant's AMC.update() — shared spaces
                pf_owner = rec_owner
                rec_owner = {}
                swaps += 1
            cur_epoch[k] = epoch
        key = view.within_epoch
        read0, write0 = storage.read_bytes, storage.write_bytes
        dropped0 = storage.dropped_entries

        rec = storage.lookup(key)
        lookups[k] += 1
        if rec is not None:
            hits[k] += 1
            if pf_owner.get(key, k) != k:
                aliased[k] += 1
        issued = prefetcher._prefetch(view, rec, storage)
        if issued is not None:
            out_blocks[k].append(issued[0])
            out_pos[k].append(issued[1])

        prev_tbl = storage.recording.get(key)
        prefetcher._record(view, storage, stats[k])
        new_tbl = storage.recording.get(key)
        if new_tbl is not None and new_tbl is not prev_tbl:
            owner = rec_owner.get(key)
            if prev_tbl is not None and owner is not None and owner != k:
                cross_overwrites += 1
                thrashed_entries += prev_tbl.num_entries
                evicted[owner] += 1
            rec_owner[key] = k

        read_d[k] += storage.read_bytes - read0
        write_d[k] += storage.write_bytes - write0
        dropped_d[k] += storage.dropped_entries - dropped0

    streams = []
    for k in range(k_tenants):
        blocks = (
            np.concatenate(out_blocks[k])
            if out_blocks[k]
            else np.zeros(0, np.int64)
        )
        pos = (
            np.concatenate(out_pos[k]) if out_pos[k] else np.zeros(0, np.int64)
        )
        streams.append(
            PrefetchStream(
                name=cfg.name,
                blocks=blocks,
                pos=pos,
                metadata_bytes=int(read_d[k] + write_d[k]),
                info=dict(
                    compression_ratio=stats[k].ratio,
                    mode_counts=stats[k].mode_counts,
                    entries=stats[k].entries,
                    storage_peak_bytes=storage.peak_bytes,
                    storage_cap_bytes=storage.capacity_bytes,
                    dropped_entries=int(dropped_d[k]),
                    metadata_read_bytes=int(read_d[k]),
                    metadata_write_bytes=int(write_d[k]),
                ),
            )
        )
    counters = dict(
        table_swaps=swaps,
        cross_tenant_overwrites=cross_overwrites,
        thrashed_entries=thrashed_entries,
        aliased_hits=int(aliased.sum()),
        shared_capacity_bytes=storage.capacity_bytes,
        per_tenant=[
            dict(
                lookups=int(lookups[k]),
                lookup_hits=int(hits[k]),
                aliased_hits=int(aliased[k]),
                recordings_evicted=int(evicted[k]),
            )
            for k in range(k_tenants)
        ],
    )
    return streams, counters


__all__ = ["shared_table_streams"]
