"""Pure-Python oracle for the set-parallel LRU kernel.

Simulates each padded substream row with an explicit LRU dict — the same
machine as :func:`repro_torch.memsim.scan_cache.cache_pass` restricted to one
set, written for obviousness rather than speed (tests use tiny shapes).
"""
from __future__ import annotations

import numpy as np


def lru_hits_ref(padded: np.ndarray, ways: int) -> np.ndarray:
    """Hit mask (int32 0/1) per cell of a ``(sets, L)`` substream matrix.

    Pad cells (block ``-1``) are skipped (reported as 0).  The kernel
    instead runs its machine over them, so kernel and oracle only agree on
    real-access cells — pads are tail-only by construction, can therefore
    never influence a real cell, and are never consumed by callers;
    comparisons must mask to ``padded >= 0``.
    """
    sets, length = padded.shape
    hits = np.zeros((sets, length), dtype=np.int32)
    for s in range(sets):
        state: dict = {}  # block -> last-use time
        for t in range(length):
            b = int(padded[s, t])
            if b < 0:
                continue
            if b in state:
                hits[s, t] = 1
            elif len(state) >= ways:
                lru = min(state, key=state.get)
                del state[lru]
            state[b] = t + 1
    return hits
