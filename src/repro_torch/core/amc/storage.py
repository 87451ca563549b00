"""Off-chip AMC metadata storage model (paper §V-B, Fig 4).

Two metadata spaces exist simultaneously — one being recorded into, one
being prefetched from — each holding a *Miss Addresses* region (compressed
miss streams, FIFO) and an *AMC Index* region (per-entry: two target
addresses, compression mode, miss count, pointer). `swap()` is the
role-reversal performed by ``AMC.update()`` at every iteration boundary.

The OS reserves at most ``capacity_bytes`` (20% of the application input
size, §IV-A) per space; recording that would overflow is dropped (counted,
visible in the Fig 15 storage benchmark).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# Per index entry: two target *deltas* (§V-B: "only the delta of the target
# accesses is recorded"), compression mode + miss count, pointer, valid.
INDEX_ENTRY_BYTES = 2 * 3 + 1 + 4 + 1  # = 12


def intra_rank(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated (ragged-expansion helper)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.zeros(len(counts), dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


@dataclasses.dataclass
class AMCEntryTable:
    """One recorded iteration's correlation entries (struct of ragged arrays)."""

    iteration: int
    trigger_vid: np.ndarray  # (E,) current (second) target vertex id
    prev_vid: np.ndarray  # (E,) previous target vertex id
    mode: np.ndarray  # (E,) int8
    nmiss: np.ndarray  # (E,)
    bits: np.ndarray  # (E,) compressed size in bits
    miss_offsets: np.ndarray  # (E+1,) ragged offsets into miss_blocks
    miss_blocks: np.ndarray  # concatenated miss block ids
    truncated: bool = False  # storage cap hit while recording
    age: int = 0  # epochs since recorded (cross-epoch lifecycle only)

    def subset(self, keep: np.ndarray) -> "AMCEntryTable":
        """A new table holding only the entries selected by ``keep``
        (boolean mask over entries), ragged miss streams re-packed."""
        keep_idx = np.flatnonzero(keep)
        nm = self.nmiss[keep_idx].astype(np.int64)
        gather = np.repeat(self.miss_offsets[keep_idx], nm) + intra_rank(nm)
        offsets = np.zeros(len(keep_idx) + 1, dtype=np.int64)
        np.cumsum(nm, out=offsets[1:])
        return AMCEntryTable(
            iteration=self.iteration,
            trigger_vid=self.trigger_vid[keep_idx],
            prev_vid=self.prev_vid[keep_idx],
            mode=self.mode[keep_idx],
            nmiss=self.nmiss[keep_idx],
            bits=self.bits[keep_idx],
            miss_offsets=offsets,
            miss_blocks=self.miss_blocks[gather],
            truncated=self.truncated,
            age=self.age,
        )

    @property
    def num_entries(self) -> int:
        return len(self.trigger_vid)

    @property
    def miss_bytes(self) -> int:
        return int(self.bits.sum() + 7) // 8

    @property
    def index_bytes(self) -> int:
        return self.num_entries * INDEX_ENTRY_BYTES

    @property
    def total_bytes(self) -> int:
        return self.miss_bytes + self.index_bytes


class AMCStorage:
    """The pair of role-swapping metadata spaces + traffic accounting."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        self.recording: Dict[int, AMCEntryTable] = {}
        self.prefetching: Dict[int, AMCEntryTable] = {}
        self.write_bytes = 0  # off-chip metadata writes (recording)
        self.read_bytes = 0  # off-chip metadata reads (prefetch phase)
        self.dropped_entries = 0
        self.peak_bytes = 0
        # Cross-epoch lifecycle accounting (repro_torch.stream.lifecycle):
        self.lookup_hits = 0  # lookups that found a table
        self.lookup_misses = 0  # lookups with no table for the iteration
        self.stale_hits = 0  # hits on tables older than one epoch (age > 0)
        self.invalidated_entries = 0  # dropped by invalidate_triggers()
        self.aged_out_tables = 0  # dropped by swap_retaining() age cap

    def record_bytes_used(self) -> int:
        return sum(t.total_bytes for t in self.recording.values())

    def store(self, table: AMCEntryTable) -> AMCEntryTable:
        """Record a table, enforcing the capacity cap (drops the tail)."""
        used = self.record_bytes_used()
        if used + table.total_bytes > self.capacity_bytes:
            # Keep the prefix of entries that fits.
            budget = max(self.capacity_bytes - used, 0)
            per_entry = (np.asarray(table.bits, dtype=np.int64) + 7) // 8 + INDEX_ENTRY_BYTES
            cum = np.cumsum(per_entry)
            keep = int(np.searchsorted(cum, budget, side="right"))
            self.dropped_entries += table.num_entries - keep
            end = int(table.miss_offsets[keep])
            table = AMCEntryTable(
                iteration=table.iteration,
                trigger_vid=table.trigger_vid[:keep],
                prev_vid=table.prev_vid[:keep],
                mode=table.mode[:keep],
                nmiss=table.nmiss[:keep],
                bits=table.bits[:keep],
                miss_offsets=table.miss_offsets[: keep + 1],
                miss_blocks=table.miss_blocks[:end],
                truncated=True,
            )
        self.recording[table.iteration] = table
        self.write_bytes += table.total_bytes
        self.peak_bytes = max(
            self.peak_bytes, self.record_bytes_used(), self.prefetch_bytes_used()
        )
        return table

    def prefetch_bytes_used(self) -> int:
        return sum(t.total_bytes for t in self.prefetching.values())

    def lookup(self, iteration: int) -> Optional[AMCEntryTable]:
        table = self.prefetching.get(iteration)
        if table is None:
            self.lookup_misses += 1
        else:
            self.lookup_hits += 1
            if table.age > 0:
                self.stale_hits += 1
        return table

    def charge_read(self, nbytes: int):
        self.read_bytes += int(nbytes)

    def swap(self):
        """AMC.update(): the freshly recorded space becomes the prefetch
        space; the old prefetch space is invalidated and recycled."""
        self.prefetching = self.recording
        self.recording = {}

    def swap_retaining(self, max_age: int):
        """Epoch-boundary swap that *retains* old tables as aged fallbacks.

        The ``age`` lifecycle policy: iterations re-recorded this epoch get
        their fresh table; iterations the new epoch did not reach keep the
        previous table with its age incremented, up to ``max_age`` epochs —
        LRU-style aging instead of the hard invalidation of :meth:`swap`.
        """
        old = self.prefetching
        fresh = dict(self.recording)
        for it, table in old.items():
            if it in fresh:
                continue
            if table.age + 1 > max_age:
                self.aged_out_tables += 1
                continue
            table.age += 1
            fresh[it] = table
        self.prefetching = fresh
        self.recording = {}

    def invalidate_triggers(self, changed_vids: np.ndarray) -> int:
        """Drop prefetch-space entries whose trigger vertex is in
        ``changed_vids`` (sorted unique ids) — the ``invalidate_changed``
        policy: a changed vertex's recorded miss stream describes a
        neighborhood that no longer exists.  Returns entries dropped."""
        dropped = 0
        changed = np.asarray(changed_vids, dtype=np.int64)
        for it, table in list(self.prefetching.items()):
            if table.num_entries == 0:
                continue
            stale = np.isin(table.trigger_vid, changed)
            n_stale = int(stale.sum())
            if n_stale == 0:
                continue
            dropped += n_stale
            self.prefetching[it] = table.subset(~stale)
        self.invalidated_entries += dropped
        return dropped

    def tables(self) -> List[AMCEntryTable]:
        return list(self.prefetching.values()) + list(self.recording.values())
