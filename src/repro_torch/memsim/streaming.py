"""Bounded-memory streaming scoring over chunked (sharded) traces
(PyTorch port of ``repro.memsim.streaming``).

The whole-trace scorer (:func:`repro_torch.memsim.hierarchy.simulate_with_prefetch`
+ :func:`repro_torch.memsim.metrics.evaluate`) materializes every per-event array
for the full run.  This module re-expresses that pipeline as a sequence of
per-chunk passes whose peak memory is O(chunk) in the trace length (working
tables are proportional to the number of *distinct* blocks touched — the
graph footprint — never to the stream length):

- :class:`SpillFile` — raw int64 column spills for position streams that a
  later stage must re-read (MLP measurement, the AMC training views).
- :func:`spilled_mlp` — :func:`repro_torch.memsim.timing.measure_mlp` replicated
  over a spilled position stream, bit-identical including its subsample
  stride and the float64 mean.
- :class:`ClassifyCarry` + :func:`classify_chunk` — the chunked counterpart
  of :func:`repro_torch.memsim.scan_cache.classify_prefetch_events`: a per-block
  carry table (last fill position/issuer, the all-prefetx-since-fill tail
  bit, a pending early-eviction fill) makes per-chunk classification exactly
  equal to whole-trace classification.
- :class:`BlockPosTable` — per-block last-position table (the streaming
  form of :func:`repro_torch.memsim.hierarchy._no_future_demand`).
- :class:`CompositeRunScorer` — one composite run (demand + prefetch merge,
  L2 + LLC passes with carried :class:`~repro_torch.memsim.engine.CacheState`,
  classification, windowed count accumulation, MLP spills) fed chunk by
  chunk; ``finalize`` reproduces ``metrics._outcome_cycles`` exactly.

The cache passes run on the scorer's device (``device=``, default the
CUDA card): kernel K1 resumes each level from a :class:`CacheState` that
stays on that device across chunks, and only the hit masks come back to
the host, where the rest of the pipeline runs in numpy.  Every count and
float produced here equals the unsharded scorer's and the JAX package's
(``tests/test_torch_streaming.py``).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.memsim.config import HierarchyConfig
from repro_torch.memsim.engine import CacheState, cache_pass, init_state
from repro_torch.memsim.timing import TimingModel, estimate_cycles


def _stage(name: str):
    from repro_torch.core.exec.timers import stage  # lazy: import cycle at load

    return stage(name)


# ------------------------------------------------------------------ spills


class SpillFile:
    """Append-only on-disk store of int64 rows with ``cols`` columns.

    Rows are written raw (native-endian int64, row-major), so a spill of a
    position stream costs 8 bytes/column/row and reads back in fixed-size
    chunks without ever materializing the whole stream.
    """

    def __init__(self, path, cols: int = 1):
        self.path = Path(path)
        self.cols = cols
        self.rows = 0
        self._fh = open(self.path, "wb")

    def append(self, *columns: np.ndarray) -> None:
        if len(columns) != self.cols:
            raise ValueError(f"expected {self.cols} columns, got {len(columns)}")
        n = len(columns[0])
        if n == 0:
            return
        if self.cols == 1:
            out = np.ascontiguousarray(columns[0], dtype=np.int64)
        else:
            out = np.empty((n, self.cols), dtype=np.int64)
            for j, c in enumerate(columns):
                if len(c) != n:
                    raise ValueError("ragged spill append")
                out[:, j] = c
        out.tofile(self._fh)
        self.rows += n

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def groups(self, counts: Sequence[int]) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield column tuples of exactly ``counts[i]`` rows each, in write
        order — the per-chunk replay reader (``sum(counts) <= rows``)."""
        self.flush()
        with open(self.path, "rb") as fh:
            for c in counts:
                flat = np.fromfile(fh, dtype=np.int64, count=int(c) * self.cols)
                mat = flat.reshape(int(c), self.cols)
                yield tuple(mat[:, j].copy() for j in range(self.cols))

    def chunks(self, rows: int = 1 << 20) -> Iterator:
        """Yield column tuples (or bare arrays when ``cols == 1``) of up to
        ``rows`` rows each, in write order.  Flushes the writer first."""
        self.flush()
        done = 0
        with open(self.path, "rb") as fh:
            while done < self.rows:
                take = min(rows, self.rows - done)
                flat = np.fromfile(fh, dtype=np.int64, count=take * self.cols)
                done += take
                if self.cols == 1:
                    yield flat
                else:
                    mat = flat.reshape(take, self.cols)
                    yield tuple(mat[:, j].copy() for j in range(self.cols))


def spilled_mlp(spill: SpillFile, window: int, cap: float, rows: int = 1 << 20) -> float:
    """:func:`repro_torch.memsim.timing.measure_mlp` over a spilled position
    stream (already ascending, distinct — both true of every miss-position
    stream here), bit-identical to the in-memory version.

    A sample taken at global index ``i`` counts entries in ``[v, v+window]``;
    entries in earlier chunks are all ``< v`` and entries in later chunks all
    ``> chunk[-1]``, so a sample finalizes as soon as a chunk tail exceeds
    ``v + window`` — unfinalized samples carry their partial counts forward.
    """
    n = spill.rows
    if n < 2:
        return 1.0
    stride = max(n // 1_000_000, 1)
    total = 0
    nsamp = 0
    pend_v = np.zeros(0, dtype=np.int64)
    pend_c = np.zeros(0, dtype=np.int64)
    gidx = 0
    for arr in spill.chunks(rows):
        if len(arr) == 0:
            continue
        if len(pend_v):
            pend_c = pend_c + np.searchsorted(arr, pend_v + window, side="right")
            fin = arr[-1] > pend_v + window
            total += int(pend_c[fin].sum())
            nsamp += int(fin.sum())
            pend_v, pend_c = pend_v[~fin], pend_c[~fin]
        first = (-gidx) % stride
        j = np.arange(first, len(arr), stride, dtype=np.int64)
        if len(j):
            v = arr[j]
            cnt = np.searchsorted(arr, v + window, side="right") - j
            fin = arr[-1] > v + window
            total += int(cnt[fin].sum())
            nsamp += int(fin.sum())
            pend_v = np.concatenate([pend_v, v[~fin]])
            pend_c = np.concatenate([pend_c, cnt[~fin]])
        gidx += len(arr)
    total += int(pend_c.sum())
    nsamp += len(pend_v)
    # measure_mlp's .mean(): pairwise float64 summation of small ints is
    # exact (counts <= window+1 and totals < 2**53), so sum/len is the mean.
    mean = np.float64(total) / np.float64(nsamp)
    return float(np.clip(mean, 1.0, cap))


# --------------------------------------------------- sorted-table utilities


def _merge_override(
    old_key: np.ndarray,
    new_key: np.ndarray,
    old_cols: Sequence[np.ndarray],
    new_cols: Sequence[np.ndarray],
):
    """Merge two sorted unique-key tables; ``new`` wins on key collisions.

    A linear two-way merge (searchsorted + masked scatter), not
    concat-and-argsort: the table is the O(distinct blocks) term of the
    streaming scorer's footprint and this runs once per chunk, so both the
    argsort transients and the n-log-n would otherwise dominate peak RSS
    and wall-clock on paper-scale graphs."""
    if len(old_key) == 0:
        return new_key, [np.asarray(c) for c in new_cols]
    if len(new_key) == 0:
        return old_key, list(old_cols)
    i = np.searchsorted(new_key, old_key)
    safe = np.minimum(i, len(new_key) - 1)
    dup = (i < len(new_key)) & (new_key[safe] == old_key)
    ok = old_key[~dup]
    at_new = np.zeros(len(ok) + len(new_key), dtype=bool)
    at_new[np.searchsorted(ok, new_key) + np.arange(len(new_key))] = True
    k = np.empty(len(at_new), dtype=np.result_type(old_key, new_key))
    k[at_new] = new_key
    k[~at_new] = ok
    cols = []
    for oc, nc in zip(old_cols, new_cols):
        c = np.empty(len(at_new), dtype=np.result_type(oc, nc))
        c[at_new] = nc
        c[~at_new] = oc[~dup]
        cols.append(c)
    return k, cols


def _last_per_key(keys: np.ndarray, cols: Sequence[np.ndarray]):
    """(unique sorted keys, last-occurrence value per key); rows are in
    occurrence order, so a stable sort keeps the last row last."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    last = np.ones(len(k), dtype=bool)
    last[:-1] = k[:-1] != k[1:]
    return k[last], [c[order][last] for c in cols]


class BlockPosTable:
    """Per-block last position over a streamed (block, pos) event sequence.

    The streaming form of ``_no_future_demand``: after feeding every
    baseline demand L2 miss, ``has_later(b, p)`` answers "does block ``b``
    miss again strictly after position ``p``" — exactly the predicate the
    whole-trace packed-key searchsorted evaluates.
    """

    # Unseen-slot sentinel for the dense path: real positions are >= 0, so
    # the most negative int32 compares below every query position.
    _ABSENT = np.int32(-(2**31))
    # Dense slots are capped at 64 MiB of int32; a span beyond this (widely
    # scattered block ids) demotes the table to the sorted-row fallback.
    _MAX_SPAN = 1 << 24

    def __init__(self):
        # Dense path (default): trace addresses come from contiguous
        # page-aligned regions (apps.trace.TraceConfig), so block ids form
        # one dense span and a flat int32 array indexed by (block - lo)
        # updates by in-place scatter — no per-chunk merge transients.
        self._lo = 0
        self._dense = None
        # Sorted-row fallback for sparse id spans.
        self.blocks = np.zeros(0, dtype=np.int32)
        self.pos = np.zeros(0, dtype=np.int32)

    def __len__(self) -> int:
        if self._dense is not None:
            return int((self._dense != self._ABSENT).sum())
        return len(self.blocks)

    def update(self, blocks: np.ndarray, pos: np.ndarray) -> None:
        if len(blocks) == 0:
            return
        # Rows are stored as int32: the table is the O(distinct blocks)
        # footprint term, so per-row bytes matter. Block ids already must
        # fit in int32 (the cache engines assert it), and positions a
        # 2**31-access trace will never exceed.
        assert pos.min(initial=0) >= 0, "trace positions are non-negative"
        assert pos.max(initial=0) < 2**31, "trace position exceeds int32"
        assert blocks.max(initial=0) < 2**31, "block ids must fit in int32"
        ub, (up,) = _last_per_key(
            blocks.astype(np.int32), [pos.astype(np.int32)]
        )
        if self._dense is not None or len(self.blocks) == 0:
            lo, hi = int(ub[0]), int(ub[-1])
            if self._dense is not None:
                lo = min(lo, self._lo)
                hi = max(hi, self._lo + len(self._dense) - 1)
            if hi - lo + 1 <= self._MAX_SPAN:
                self._ensure_span(lo, hi)
                self._dense[ub.astype(np.int64) - self._lo] = up
                return
            self._demote()
        # Sparse fallback: overwrite existing keys in place (no
        # allocation), merge only genuinely new rows.
        n = len(self.blocks)
        if n:
            i = np.searchsorted(self.blocks, ub)
            safe = np.minimum(i, n - 1)
            hit = (i < n) & (self.blocks[safe] == ub)
            self.pos[i[hit]] = up[hit]
            if hit.all():
                return
            ub, up = ub[~hit], up[~hit]
        self.blocks, (self.pos,) = _merge_override(
            self.blocks, ub, [self.pos], [up]
        )

    def _ensure_span(self, lo: int, hi: int) -> None:
        """Grow the dense array to cover [lo, hi] (25% headroom on growth)."""
        if self._dense is None:
            self._lo = lo
            self._dense = np.full(hi - lo + 1, self._ABSENT, dtype=np.int32)
            return
        if lo >= self._lo and hi < self._lo + len(self._dense):
            return
        pad = max((hi - lo + 1) // 4, 1024)
        new_lo = lo if lo >= self._lo else max(lo - pad, 0)
        new_hi = hi if hi < self._lo + len(self._dense) else hi + pad
        if new_lo == self._lo and self._dense.base is None:
            # Right-only growth on an owned buffer: realloc in place
            # (glibc extends large blocks via mremap), so growth never
            # holds old + new copies resident at once.
            old_n = len(self._dense)
            self._dense.resize(new_hi - new_lo + 1, refcheck=False)
            self._dense[old_n:] = self._ABSENT
            return
        grown = np.full(new_hi - new_lo + 1, self._ABSENT, dtype=np.int32)
        grown[self._lo - new_lo : self._lo - new_lo + len(self._dense)] = (
            self._dense
        )
        self._lo, self._dense = new_lo, grown

    def _demote(self) -> None:
        """Convert dense content to sorted rows (sparse-span fallback)."""
        if self._dense is None:
            return
        idx = np.flatnonzero(self._dense != self._ABSENT)
        self.blocks = (idx + self._lo).astype(np.int32)
        self.pos = self._dense[idx]
        self._dense = None

    def has_later(self, qblocks: np.ndarray, qpos: np.ndarray) -> np.ndarray:
        if len(qblocks) == 0:
            return np.zeros(0, dtype=bool)
        if self._dense is not None:
            off = qblocks.astype(np.int64) - self._lo
            in_range = (off >= 0) & (off < len(self._dense))
            p = self._dense[np.clip(off, 0, len(self._dense) - 1)]
            # _ABSENT slots fail p > qpos for every valid (>= -2**30) qpos.
            return in_range & (p > qpos)
        if len(self.blocks) == 0:
            return np.zeros(len(qblocks), dtype=bool)
        # Match the table's int32 keys: a mixed-dtype searchsorted would
        # silently promote (copy) the whole table on every chunk.
        qb = qblocks.astype(np.int32)
        i = np.searchsorted(self.blocks, qb)
        safe = np.minimum(i, len(self.blocks) - 1)
        found = (i < len(self.blocks)) & (self.blocks[safe] == qb)
        return found & (self.pos[safe] > qpos)


# ------------------------------------------------ streaming classification


@dataclasses.dataclass
class ClassifyCarry:
    """Per-block residency state at a chunk seam.

    One row per block seen so far: the position (doubled units) and issuer
    of its last fill, whether every event since that fill was a prefetch
    (the ``all_pf_since_fill`` tail the next chunk resumes from), and
    whether the block's last event was a prefetch fill still awaiting its
    next same-block event (a *pending* early-eviction candidate, plus the
    selection bit it was issued under).
    """

    blocks: np.ndarray  # sorted int64
    fill_pos2: np.ndarray  # int32, doubled-position of last fill
    fill_issuer: np.ndarray  # int8 (issuer ids, -1 demand)
    all_pf_tail: np.ndarray  # bool
    pending: np.ndarray  # bool
    pending_sel: np.ndarray  # bool

    @classmethod
    def empty(cls) -> "ClassifyCarry":
        zb = np.zeros(0, dtype=bool)
        return cls(
            np.zeros(0, dtype=np.int64),
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.int8),
            zb,
            zb.copy(),
            zb.copy(),
        )


def classify_chunk(
    carry: ClassifyCarry,
    blocks: np.ndarray,
    is_pf: np.ndarray,
    pos2: np.ndarray,
    hit: np.ndarray,
    issuer: np.ndarray,
    fill_window2: int,
    t0: int,
    sel_issuer: int,
) -> Tuple[dict, ClassifyCarry]:
    """One chunk of merged (demand + prefetch) L2 events -> windowed counts.

    Mirrors :func:`~repro_torch.memsim.scan_cache.classify_prefetch_events` with
    cross-chunk chains resumed from ``carry``.  Returns the count
    increments the metrics pipeline needs (so per-event arrays never
    accumulate) and the updated carry:

    - ``useful``:    demand hits on a prefetched line, in-window, filled by
                     ``sel_issuer``  (``evaluate``'s ``useful_mask``)
    - ``late_sel``:  those that were also late
    - ``late_any``:  late useful demand events of ANY issuer, in-window
                     (``_outcome_cycles``'s ``late``)
    - ``redundant_sel``/``early_sel``: prefetch events of ``sel_issuer``
                     issued in-window that were redundant / evicted early.

    Window membership uses the event's own undoubled position
    (``pos2 >> 1``), matching ``l2_pos >= t0`` / ``pf_pos >= t0``.
    """
    counts = dict(useful=0, late_sel=0, late_any=0, redundant_sel=0, early_sel=0)
    n = len(blocks)
    if n == 0:
        return counts, carry
    key = (blocks.astype(np.int64) << np.int64(31)) | np.arange(n, dtype=np.int64)
    order = np.argsort(key)
    b = blocks[order].astype(np.int64)
    p = pos2[order]
    f = is_pf[order]
    h = hit[order]
    iss = issuer[order].astype(np.int64)

    idx = np.arange(n, dtype=np.int64)
    chain_start = np.ones(n, dtype=bool)
    chain_start[1:] = b[1:] != b[:-1]
    chain_id = np.cumsum(chain_start) - 1
    chain_first = idx[chain_start][chain_id]

    # Carry lookup for this chunk's (strictly ascending) chain blocks.
    cb = b[chain_start]
    K = len(carry.blocks)
    if K:
        ci = np.searchsorted(carry.blocks, cb)
        safe = np.minimum(ci, K - 1)
        found = (ci < K) & (carry.blocks[safe] == cb)
        cf_pos2 = np.where(found, carry.fill_pos2[safe], np.int64(-1) << 50)
        cf_issuer = np.where(found, carry.fill_issuer[safe], np.int64(-9))
        cf_tail = np.where(found, carry.all_pf_tail[safe], False)
        cf_pend = np.where(found, carry.pending[safe], False)
        cf_psel = np.where(found, carry.pending_sel[safe], False)
    else:
        cf_pos2 = np.full(len(cb), np.int64(-1) << 50)
        cf_issuer = np.full(len(cb), np.int64(-9))
        cf_tail = np.zeros(len(cb), dtype=bool)
        cf_pend = np.zeros(len(cb), dtype=bool)
        cf_psel = np.zeros(len(cb), dtype=bool)

    # Last fill at/before each event; an event whose chain segment began in
    # an earlier chunk (no local fill yet) resumes from the carried fill.
    fill_idx = np.where(~h, idx, -1)
    last_fill = np.maximum.accumulate(fill_idx)
    carried_ev = last_fill < chain_first
    lf = np.maximum(last_fill, 0)

    cnp = np.cumsum((~f).astype(np.int64))
    cnp_before = cnp - (~f)
    local_all = (cnp - cnp_before[lf]) == 0  # all pf over [last_fill .. k]
    local_from_first = (cnp - cnp_before[chain_first]) == 0
    ev_tail = cf_tail[chain_id]
    all_pf_since_fill = np.where(
        carried_ev, ev_tail & local_from_first, local_all
    )
    prev_all_pf = np.zeros(n, dtype=bool)
    prev_all_pf[1:] = all_pf_since_fill[:-1]
    prev_all_pf[chain_start] = ev_tail[chain_start]

    fillpos2 = np.where(carried_ev, cf_pos2[chain_id], p[lf])
    fill_iss = np.where(carried_ev, cf_issuer[chain_id], iss[lf])

    useful = h & ~f & prev_all_pf
    late = useful & (fillpos2 + fill_window2 > p)
    redundant = f & h

    pos_ev = p >> 1
    in_win = pos_ev >= t0
    sel_pf_ev = f & in_win & (iss == sel_issuer)
    useful_sel = useful & in_win & (fill_iss == sel_issuer)
    counts["useful"] = int(useful_sel.sum())
    counts["late_sel"] = int((late & useful_sel).sum())
    counts["late_any"] = int((late & in_win).sum())
    counts["redundant_sel"] = int((redundant & sel_pf_ev).sum())

    # Early eviction resolved inside the chunk...
    next_is_miss = np.zeros(n, dtype=bool)
    next_is_miss[:-1] = ~h[1:] & ~chain_start[1:]
    early = (~h) & f & next_is_miss
    counts["early_sel"] = int((early & sel_pf_ev).sum())
    # ...and across the seam: a carried pending prefetch fill resolves at
    # its block's first event this chunk (miss == the line was evicted).
    resolved_early = chain_start & cf_pend[chain_id] & ~h
    counts["early_sel"] += int((resolved_early & cf_psel[chain_id]).sum())

    # New carry: the last event of every chain present in this chunk.
    last_in_chain = np.ones(n, dtype=bool)
    last_in_chain[:-1] = chain_start[1:]
    li = idx[last_in_chain]
    new_pending = (~h & f)[li]
    # Rows are stored packed (int32 pos2, int8 issuer, raw bools): the
    # carry persists for the whole run, so per-row bytes — not the chunk
    # math above, which stays int64 — set the resident footprint.  Live
    # rows always saw a real fill, so only dead rows (pruned below) can
    # hold the huge-negative not-found sentinel; clamping it to -2**30
    # keeps the int32 cast exact for every row that survives.
    assert p.max(initial=0) < 2**31, "doubled position exceeds int32"
    new_blocks, new_cols = cb, [
        np.maximum(fillpos2[li], np.int64(-(2**30))).astype(np.int32),
        fill_iss[li].astype(np.int8),
        all_pf_since_fill[li],
        new_pending,
        sel_pf_ev[li],
    ]
    mb, (m_pos2, m_iss, m_tail, m_pend, m_psel) = _merge_override(
        carry.blocks,
        new_blocks,
        [
            carry.fill_pos2,
            carry.fill_issuer,
            carry.all_pf_tail,
            carry.pending,
            carry.pending_sel,
        ],
        new_cols,
    )
    # Prune rows indistinguishable from absence: with tail and pending both
    # False the lookup above yields exactly the not-found defaults (tail
    # gates every read of fill_pos2/fill_issuer via prev_all_pf, pending
    # gates pending_sel), so only blocks with an outstanding prefetch stay
    # resident — the carry tracks the prefetched-not-yet-demanded set, not
    # every block the run ever touched.
    live = m_tail | m_pend
    if not live.all():
        mb = mb[live]
        m_pos2 = m_pos2[live]
        m_iss = m_iss[live]
        m_tail = m_tail[live]
        m_pend = m_pend[live]
        m_psel = m_psel[live]
    new_carry = ClassifyCarry(
        blocks=mb,
        fill_pos2=m_pos2,
        fill_issuer=m_iss,
        all_pf_tail=m_tail,
        pending=m_pend,
        pending_sel=m_psel,
    )
    return counts, new_carry


# ------------------------------------------------- composite run streaming


def _resident(state: CacheState, blocks: np.ndarray) -> np.ndarray:
    """Which of ``blocks`` (int32) sit in the carried ``state``: the tag
    lookup runs where the state lives, and only the mask comes back."""
    b = torch.from_numpy(blocks).to(state.tags.device)
    rows = state.tags[(b & (state.sets - 1)).long()]
    return (rows == b[:, None]).any(dim=1).cpu().numpy()


class CompositeRunScorer:
    """One composite (demand + prefetch) run scored chunk by chunk.

    ``feed`` consumes one chunk's demand L2 substream (global positions,
    ascending) plus the prefetch events triggered inside the chunk's access
    range, replicating ``simulate_with_prefetch``'s merge / L2 / classify /
    LLC pipeline with carried state; ``finalize`` reproduces
    ``metrics._outcome_cycles`` from the accumulated counts and spilled
    position streams.

    ``sel_issuer=None`` skips issuer-attributed counting (the baseline
    composite run only needs the window totals).  ``miss_sink`` optionally
    receives every demand L2 miss as ``(pos, block, iter)`` rows — the
    baseline-composite miss stream AMC trains on.  The L2 and LLC states
    live on ``device`` (default the CUDA card) for the scorer's lifetime.
    """

    def __init__(
        self,
        cfg: HierarchyConfig,
        t0: int,
        spill_dir,
        tag: str,
        sel_issuer: Optional[int] = None,
        no_future: Optional[BlockPosTable] = None,
        miss_sink: Optional[SpillFile] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.t0 = t0
        self.sel = sel_issuer if sel_issuer is not None else -9
        self.count_issuer = sel_issuer is not None
        self.no_future = no_future
        self.miss_sink = miss_sink
        self.l2_state = init_state(cfg.l2.sets, cfg.l2.ways, self.device)
        self.llc_state = init_state(cfg.llc.sets, cfg.llc.ways, self.device)
        self.classify = ClassifyCarry.empty()
        # Blocks whose pending sel-issuer fill was evicted from L2: their
        # early eviction is certain but only counts if the block is ever
        # touched again (the classic path counts at the resolving event),
        # so just the block id waits here — sorted int32, one word per
        # wasted prefetch instead of a full carry row.
        self.evicted_pending = np.zeros(0, dtype=np.int32)
        d = Path(spill_dir)
        self.miss_spill = SpillFile(d / f"{tag}.misspos.i64")
        self.dram_spill = SpillFile(d / f"{tag}.drampos.i64")
        self.l2_misses = 0
        self.dram_demand = 0
        self.pf_dram = 0
        self.late_any = 0
        self.useful = 0
        self.late_sel = 0
        self.redundant = 0
        self.early = 0
        self.overpred = 0
        self.issued = 0

    def feed(
        self,
        d_pos: np.ndarray,
        d_blocks: np.ndarray,
        pf_blocks: np.ndarray,
        pf_pos: np.ndarray,
        pf_issuer: np.ndarray,
        d_iter: Optional[np.ndarray] = None,
    ) -> None:
        cfg = self.cfg
        nd = len(d_pos)
        npf = len(pf_pos)
        pf_blocks = np.asarray(pf_blocks, dtype=np.int64)
        pf_pos = np.asarray(pf_pos, dtype=np.int64)
        pf_issuer = np.asarray(pf_issuer, dtype=np.int8)
        if npf > 1:
            # Stable position sort: identity when already sorted, and the
            # same equal-position order (concat order) as the global path.
            o = np.argsort(pf_pos, kind="stable")
            pf_pos, pf_blocks, pf_issuer = pf_pos[o], pf_blocks[o], pf_issuer[o]

        total = nd + npf
        pf_slots = np.searchsorted(2 * d_pos, 2 * pf_pos + 1) + np.arange(npf)
        demand_slots = np.ones(total, dtype=bool)
        demand_slots[pf_slots] = False
        demand_slots = np.flatnonzero(demand_slots)
        mpos2 = np.empty(total, dtype=np.int64)
        mblocks = np.empty(total, dtype=np.int64)
        m_is_pf = np.zeros(total, dtype=bool)
        m_issuer = np.full(total, -1, dtype=np.int8)
        mpos2[demand_slots] = 2 * d_pos
        mpos2[pf_slots] = 2 * pf_pos + 1
        mblocks[demand_slots] = d_blocks
        mblocks[pf_slots] = pf_blocks
        m_is_pf[pf_slots] = True
        m_issuer[pf_slots] = pf_issuer

        # Settle deferred early evictions first: a block in evicted_pending
        # is absent from L2, so its first event this chunk is a guaranteed
        # miss — exactly the resolving event ``resolved_early`` counts.
        if self.count_issuer and len(self.evicted_pending):
            touched = np.isin(self.evicted_pending, mblocks.astype(np.int32))
            if touched.any():
                self.early += int(touched.sum())
                self.evicted_pending = self.evicted_pending[~touched]

        with _stage("cache_pass[l2]"):
            hit, self.l2_state = cache_pass(
                mblocks,
                cfg.l2.sets,
                cfg.l2.ways,
                state=self.l2_state,
                return_state=True,
                device=self.device,
            )
        cls_counts, self.classify = classify_chunk(
            self.classify,
            mblocks,
            m_is_pf,
            mpos2,
            hit,
            m_issuer,
            2 * cfg.pf_fill_window,
            self.t0,
            self.sel,
        )
        self.late_any += cls_counts["late_any"]
        if self.count_issuer:
            self.useful += cls_counts["useful"]
            self.late_sel += cls_counts["late_sel"]
            self.redundant += cls_counts["redundant_sel"]
            self.early += cls_counts["early_sel"]

        # Seam-time eviction pruning: a carry row whose block no longer
        # sits in the carried L2 state is nearly settled — the block's next
        # access is a guaranteed miss (only accesses insert lines), so
        # ``useful`` can never fire off the row and everything but a
        # sel-issuer pending bit reads back as the not-found defaults.
        # Dropping such rows (parking pending+sel ones as bare block ids in
        # ``evicted_pending``) is bit-identical to carrying them and caps
        # the carry at O(L2 capacity) instead of O(every block ever
        # prefetched).
        car = self.classify
        if len(car.blocks):
            cb32 = car.blocks.astype(np.int32)
            resident = _resident(self.l2_state, cb32)
            if not resident.all():
                if self.count_issuer:
                    parked = cb32[car.pending & car.pending_sel & ~resident]
                    if len(parked):
                        self.evicted_pending = np.unique(
                            np.concatenate([self.evicted_pending, parked])
                        )
                self.classify = ClassifyCarry(
                    blocks=car.blocks[resident],
                    fill_pos2=car.fill_pos2[resident],
                    fill_issuer=car.fill_issuer[resident],
                    all_pf_tail=car.all_pf_tail[resident],
                    pending=car.pending[resident],
                    pending_sel=car.pending_sel[resident],
                )

        llc_sel = ~hit
        with _stage("cache_pass[llc]"):
            llc_hit, self.llc_state = cache_pass(
                mblocks[llc_sel],
                cfg.llc.sets,
                cfg.llc.ways,
                state=self.llc_state,
                return_state=True,
                device=self.device,
            )
        llc_is_pf = m_is_pf[llc_sel]
        llc_pos = mpos2[llc_sel] >> 1

        d_hit = hit[demand_slots]
        miss_pos = d_pos[~d_hit]
        in_win = miss_pos >= self.t0
        self.l2_misses += int(in_win.sum())
        self.miss_spill.append(miss_pos[in_win])
        d_llc_miss = ~llc_hit[~llc_is_pf]
        self.dram_demand += int((d_llc_miss & in_win).sum())
        dram_pos = miss_pos[d_llc_miss]
        self.dram_spill.append(dram_pos[dram_pos >= self.t0])
        pf_llc_pos = llc_pos[llc_is_pf]
        self.pf_dram += int(
            ((~llc_hit)[llc_is_pf] & (pf_llc_pos >= self.t0)).sum()
        )

        if self.count_issuer:
            sel_pf = (pf_pos >= self.t0) & (pf_issuer == self.sel)
            self.issued += int(sel_pf.sum())
            if self.no_future is not None:
                has_future = self.no_future.has_later(pf_blocks, pf_pos)
                self.overpred += int((sel_pf & ~has_future).sum())
        if self.miss_sink is not None:
            mi = (
                d_iter[~d_hit].astype(np.int64)
                if d_iter is not None
                else np.zeros(len(miss_pos), dtype=np.int64)
            )
            self.miss_sink.append(miss_pos, d_blocks[~d_hit], mi)

    def finalize(
        self,
        base: dict,
        dram_baseline: int,
        late_cost: float,
        meta_dram: int,
        tm: TimingModel,
    ) -> Tuple[float, dict]:
        """(cycles, counts) exactly as ``metrics._outcome_cycles`` returns."""
        empty = np.zeros(0, dtype=np.int64)
        mlp_llc = spilled_mlp(self.miss_spill, tm.mlp_window, tm.mlp_cap_llc)
        mlp_dram = spilled_mlp(self.dram_spill, tm.mlp_window, tm.mlp_cap_dram)
        dram_total = self.dram_demand + self.pf_dram + meta_dram
        cycles = estimate_cycles(
            num_accesses=base["accesses"],
            l1_misses=base["l1_miss"],
            l2_misses_demand=self.l2_misses,
            dram_demand=self.dram_demand,
            dram_total=dram_total,
            dram_baseline=dram_baseline,
            late_useful=self.late_any,
            l2_miss_pos=empty,
            dram_pos=empty,
            cfg=self.cfg,
            tm=tm,
            late_miss_cost=late_cost,
            mlp_llc=mlp_llc,
            mlp_dram=mlp_dram,
        )
        counts = dict(
            l2_misses=self.l2_misses,
            dram_demand=self.dram_demand,
            pf_dram=self.pf_dram,
            dram_total=dram_total,
            late=self.late_any,
        )
        self.miss_spill.close()
        self.dram_spill.close()
        return cycles, counts


def iter_grouped(
    spill: SpillFile, group_col: int, n_groups: int, rows: int = 1 << 20
) -> Iterator[Tuple[int, List[np.ndarray]]]:
    """Yield ``(group_id, columns)`` for ids ``0..n_groups-1`` in order.

    ``spill[:, group_col]`` must be nondecreasing (iteration-sorted spills
    are).  Groups with no rows yield empty columns, so callers see every
    group — the per-iteration AMC views include empty iterations exactly
    like the whole-trace path.
    """
    empties = [np.zeros(0, dtype=np.int64) for _ in range(spill.cols)]
    pending: Optional[List[np.ndarray]] = None
    cur = 0
    for chunk in spill.chunks(rows):
        cols = list(chunk) if spill.cols > 1 else [chunk]
        g = cols[group_col]
        while len(g):
            first = int(g[0])
            if first > cur:
                yield cur, pending if pending is not None else [c.copy() for c in empties]
                pending = None
                cur += 1
                continue
            end = int(np.searchsorted(g, cur, side="right"))
            take = [c[:end] for c in cols]
            pending = (
                take
                if pending is None
                else [np.concatenate([p, t]) for p, t in zip(pending, take)]
            )
            cols = [c[end:] for c in cols]
            g = cols[group_col]
            if len(g):  # rows for a later group follow: ``cur`` is complete
                yield cur, pending
                pending = None
                cur += 1
    if pending is not None:
        yield cur, pending
        cur += 1
    while cur < n_groups:
        yield cur, [c.copy() for c in empties]
        cur += 1


__all__ = [
    "BlockPosTable",
    "ClassifyCarry",
    "CompositeRunScorer",
    "SpillFile",
    "classify_chunk",
    "iter_grouped",
    "spilled_mlp",
]
