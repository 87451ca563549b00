"""RnR [68]: software-assisted record-and-replay (record ONCE, replay forever).

RnR records the L2 miss sequence of the software-marked irregular structures
during the initial iteration and replays that exact sequence in every later
iteration, paced by a window counter. It has no re-recording — which is
precisely what breaks on evolving graphs (the paper's motivation for AMC).

Model: record epoch 0's miss stream per within-epoch iteration; in every
later epoch replay it, interpolating replay positions across the matching
iteration's span (window-count pacing) with the RnR buffer lead. Drift
between the recorded pattern and the changed iteration's actual needs shows
up as useless/early prefetches, exactly as in the paper (1.7% coverage on
PGD-class dynamics, competitive on near-static BellmanFord).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.amc.prefetcher import PrefetchStream
from repro_torch.core.registry import register_prefetcher


@register_prefetcher(
    "rnr",
    trains_on="l2_miss",
    storage="off-chip recorded miss sequence (record once)",
    family="replay",
)
def rnr(workload) -> PrefetchStream:
    views = workload.amc_iteration_views()
    lead = 2 * workload.profile.cfg.pf_fill_window
    recorded: Dict[int, np.ndarray] = {}
    out_b, out_p = [], []
    meta = 0
    for view, epoch in views:
        if epoch == 0:
            # record-once phase (software replay-timing control, §Table I)
            recorded[view.within_epoch] = view.miss_blocks
            meta += len(view.miss_blocks) * 6  # 46-bit offsets stored off-chip
            continue
        rec = recorded.get(view.within_epoch)
        if rec is None or len(rec) == 0 or len(view.target_pos) == 0:
            continue
        span_lo = int(view.target_pos[0])
        span_hi = int(view.target_pos[-1]) + 1
        L = len(rec)
        # window-count pacing across the iteration's span
        replay_pos = span_lo + (np.arange(L, dtype=np.int64) * max(span_hi - span_lo, 1)) // L
        out_b.append(rec)
        out_p.append(np.maximum(replay_pos - lead, 0))
        meta += L * 6
    b = np.concatenate(out_b) if out_b else np.zeros(0, np.int64)
    p = np.concatenate(out_p) if out_p else np.zeros(0, np.int64)
    return PrefetchStream("rnr", b, p, metadata_bytes=meta)
