"""Trivial / modeled prefetchers: extra next-line, DROPLET/Prodigy model, IDEAL."""
from __future__ import annotations

import numpy as np

from repro_torch.apps.trace import BLOCK_BITS, P_ID
from repro_torch.core.amc.prefetcher import PrefetchStream
from repro_torch.core.registry import register_prefetcher


@register_prefetcher(
    "nextline2",
    trains_on="l2_access",
    storage="none",
    family="spatial",
)
def nextline_extra(workload) -> PrefetchStream:
    """A second next-line (degree 2 total with the baseline's)."""
    pos, blocks, _, _ = workload.l2_stream()
    keep = np.ones(len(blocks), dtype=bool)
    keep[1:] = blocks[1:] != blocks[:-1]
    return PrefetchStream("nextline2", blocks[keep] + 2, pos[keep])


@register_prefetcher(
    "prodigy",
    trains_on="baseline_l2_miss",
    storage="software data-flow graph",
    family="dataflow",
)
def droplet_model(workload) -> PrefetchStream:
    """DROPLET/Prodigy dependency-prefetch model (paper §VII-A quantitative
    comparison, via the RnR paper's DROPLET model).

    Two modeled deficiencies: (1) a vertex-property address is computed only
    when the edge value it depends on arrives from DRAM, so the prefetch
    leads the demand by roughly one L2->core hop (accurate but barely
    early); (2) no control-flow knowledge — the dataflow walks *every*
    present vertex's neighbors, so data for inactive vertices is fetched
    too, thrashing the L2 (the paper: Prodigy "cannot account for additional
    control-flow information that leads to cache thrashing")."""
    mpos, mblocks, _ = workload.baseline_miss_stream()
    lead = 2
    pf_b = [mblocks.copy()]
    pf_p = [np.maximum(mpos - lead, 0)]
    # Control-flow-blind overfetch: P-array rows of untouched vertices,
    # paced across each iteration (volume ~= inactive fraction).
    p_base, p_size = workload.cfg_trace.region(P_ID)
    p_lo = p_base >> BLOCK_BITS
    p_blocks_total = p_size >> BLOCK_BITS
    views = workload.amc_iteration_views()
    for view, _ in views:
        if len(view.target_pos) < 2:
            continue
        touched = np.unique(view.miss_blocks)
        allp = np.arange(p_lo, p_lo + p_blocks_total, dtype=np.int64)
        untouched = np.setdiff1d(allp, touched, assume_unique=True)
        if len(untouched) == 0:
            continue
        span_lo, span_hi = int(view.target_pos[0]), int(view.target_pos[-1])
        reppos = span_lo + (
            np.arange(len(untouched), dtype=np.int64)
            * max(span_hi - span_lo, 1)
        ) // len(untouched)
        pf_b.append(untouched)
        pf_p.append(reppos)
    return PrefetchStream(
        "prodigy",
        np.concatenate(pf_b),
        np.concatenate(pf_p),
        metadata_bytes=0,
    )


@register_prefetcher(
    "ideal",
    trains_on="oracle",
    storage="none",
    family="bound",
)
def ideal_l2(workload) -> PrefetchStream:
    """IDEAL (infinite L2) bound: every baseline miss prefetched exactly one
    fill-window early — used as the Fig 8 'IDEAL' reference."""
    mpos, mblocks, _ = workload.baseline_miss_stream()
    lead = 2 * workload.profile.cfg.pf_fill_window
    return PrefetchStream("ideal", mblocks.copy(), np.maximum(mpos - lead, 0))
