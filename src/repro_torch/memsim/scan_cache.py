"""Reference cache pass: a serial one-access-per-step host loop.

This is the *correctness oracle* of the simulator, not its hot path: the
default engines run kernel K1 / K2 (:mod:`repro_torch.memsim.engine`,
:mod:`repro_torch.memsim.fused`), whose hit masks must be bit-identical to
this one.  Select it with ``REPRO_TORCH_CACHE_ENGINE=reference`` or
``engine.use_engine("reference")``.  It mirrors the JAX package's
``repro.memsim.scan_cache._plain_pass``: true LRU via a monotone age
counter; a hit takes the hit way, a miss the lowest age, ties to the lowest
way.

Every engine emits only the per-access hit bit; prefetch-classification
state (pf bits, fill times) is reconstructed exactly from the hit mask by
the segmented chain analysis in :func:`classify_prefetch_events` below (a
hit implies continuous residency since the previous same-block event, so
per-line state is a function of the block's event chain alone).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _plain_pass(blocks: np.ndarray, tags: list, age: list, sets: int) -> np.ndarray:
    """Serial LRU over ``blocks`` on per-set lists ``tags`` / ``age``
    (updated in place); the age stamp is the stream position plus 1."""
    mask = sets - 1
    hits = np.zeros(len(blocks), dtype=bool)
    for t, b in enumerate(blocks.tolist()):
        row_t, row_a = tags[b & mask], age[b & mask]
        if b in row_t:
            way = row_t.index(b)
            hits[t] = True
        else:
            way = row_a.index(min(row_a))
        row_t[way] = b
        row_a[way] = t + 1
    return hits


def cache_pass(
    blocks: np.ndarray,
    sets: int,
    ways: int,
    state=None,
    return_state: bool = False,
    device=None,
):
    """Reference hit mask for one cache level (serial per-access loop).

    Prefer :func:`repro_torch.memsim.engine.cache_pass`, which dispatches
    here under the ``reference`` engine.  ``state`` / ``return_state``
    thread the canonical :class:`~repro_torch.memsim.engine.CacheState`
    carry; the returned state lies on ``device``.
    """
    from repro_torch.memsim import engine  # deferred: engine imports this module

    dev = resolve_device(device)
    st = state if state is not None else engine.init_state(sets, ways, dev)
    blocks = np.asarray(blocks)
    if len(blocks) == 0:
        hits = np.zeros(0, dtype=bool)
        if not return_state:
            return hits
        return hits, engine.CacheState(st.tags.to(dev).clone(), st.age.to(dev).clone())
    if blocks.max(initial=0) >= 2**31:
        raise ValueError("block ids must fit in int32")
    tags = st.tags.cpu().tolist()
    age = st.age.cpu().tolist()
    hits = _plain_pass(blocks.astype(np.int64), tags, age, sets)
    if not return_state:
        return hits
    return hits, engine.canonicalize_state(
        torch.tensor(tags, dtype=torch.int32, device=dev),
        torch.tensor(age, dtype=torch.int32, device=dev),
    )


def classify_prefetch_events(
    blocks: np.ndarray,
    is_pf: np.ndarray,
    pos: np.ndarray,
    hit: np.ndarray,
    fill_window: int,
):
    """Reconstruct per-event prefetch semantics from the hit mask.

    Within one block's event chain (events already in stream order):
      - every chain segment starts at a fill (miss);
      - the line's pf bit after event e is ``is_pf[e] & (miss[e] | pf_before)``
        which unrolls to "every event since the last fill was a prefetch";
      - the fill time is set by the fill event only (redundant prefetch hits
        do not refresh it), so lateness compares the *fill* event's position.

    Returns (useful, late, redundant, early_evicted, fill_origin) in the
    original event order. ``early_evicted`` marks prefetch fills whose line
    was evicted before the next same-block access (the next chain event is a
    miss). ``fill_origin[k]`` is the original index of the event that filled
    the line consumed by useful event ``k`` (-1 where not useful) — used to
    attribute useful prefetches to their issuer in composite setups.
    """
    n = len(blocks)
    if n == 0:
        z = np.zeros(0, dtype=bool)
        return z, z, z, z, np.full(0, -1, dtype=np.int64)
    # Chains contiguous, stream order inside: single-key sort on a packed
    # (block, stream-index) key is ~2x faster than lexsort at 10M+ events.
    key = (blocks.astype(np.int64) << np.int64(31)) | np.arange(n, dtype=np.int64)
    order = np.argsort(key)
    b = blocks[order]
    p = pos[order]
    f = is_pf[order]
    h = hit[order]

    idx = np.arange(n, dtype=np.int64)
    chain_start = np.ones(n, dtype=bool)
    chain_start[1:] = b[1:] != b[:-1]

    # Last fill (miss event) at or before each position. Chains start with a
    # miss (cold caches), so the accumulate never crosses chain boundaries.
    fill_idx = np.where(~h, idx, -1)
    last_fill = np.maximum.accumulate(fill_idx)

    # all(is_pf[last_fill .. k]) via prefix sums of ~is_pf.
    cnp = np.cumsum((~f).astype(np.int32))
    cnp_before = cnp - (~f)  # exclusive prefix
    all_pf_since_fill = (cnp - cnp_before[last_fill]) == 0  # inclusive of k

    # pf state *before* event k = all_pf over [last_fill .. k-1] and line
    # resident (h[k]); since h[k] implies last event before k is the chain
    # predecessor, this equals all_pf_since_fill evaluated at k-1 of chain.
    prev_all_pf = np.zeros(n, dtype=bool)
    prev_all_pf[1:] = all_pf_since_fill[:-1]
    prev_all_pf[chain_start] = False

    useful = h & ~f & prev_all_pf
    # A useful event is a hit, so its last_fill is the prefetch fill itself.
    late = useful & (p[np.maximum(last_fill, 0)] + fill_window > p)
    redundant = f & h

    # Early eviction: a prefetch *fill* whose next same-block event misses.
    next_is_miss = np.zeros(n, dtype=bool)
    next_is_miss[:-1] = ~h[1:] & ~chain_start[1:]
    early = (~h) & f & next_is_miss

    # Fill origin (original event index) for useful events.
    fill_origin_sorted = np.where(useful, order[np.maximum(last_fill, 0)], -1)

    out = np.zeros((4, n), dtype=bool)
    out[0][order] = useful
    out[1][order] = late
    out[2][order] = redundant
    out[3][order] = early
    fill_origin = np.full(n, -1, dtype=np.int64)
    fill_origin[order] = fill_origin_sorted
    return out[0], out[1], out[2], out[3], fill_origin
