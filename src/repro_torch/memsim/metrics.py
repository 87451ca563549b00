"""Prefetcher evaluation metrics (paper Figs 8-13) from simulation outcomes.

The paper's setup is *composite*: the baseline system already runs a
next-line L2 prefetcher, and every evaluated prefetcher runs alongside it
(§VII: "The baseline system uses the next-line prefetcher as the L2 data
prefetcher"). So:

  baseline run  = demand + next-line           (issuer 0)
  evaluated run = demand + next-line + X       (X = issuer 1)

``evaluate`` scores issuer X against the *baseline run*: coverage counts
X-attributed useful prefetches against the baseline run's L2 misses, speedup
compares composite cycles against baseline-run cycles, and traffic compares
total DRAM accesses. ``eval_from_pos`` restricts every count to accesses
at/after that position — the paper evaluates BFS/BellmanFord on the second
(post-change) run only.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.memsim.config import BLOCK_BITS
from repro_torch.memsim.hierarchy import DemandProfile, PrefetchOutcome
from repro_torch.memsim.timing import TimingModel, avg_miss_cost, estimate_cycles


@dataclasses.dataclass
class PrefetchMetrics:
    name: str
    accuracy: float  # useful / issued                     (Fig 10)
    coverage: float  # useful / baseline L2 misses         (Fig 9)
    speedup: float  # baseline cycles / prefetcher cycles  (Fig 8)
    ipc_baseline: float
    ipc_prefetch: float
    issued: int
    useful: int
    late: int
    evicted_early: int
    overpredicted: int  # issued with no future demand (Fig 11 breakdown)
    redundant: int
    baseline_l2_misses: int
    extra_traffic: float  # (PrefDram - DemandDram)/DemandDram   (Fig 12)
    metadata_traffic: float  # metadata DRAM / DemandDram        (Fig 13)
    dram_demand: int
    dram_total: int
    info: dict = dataclasses.field(default_factory=dict)

    def row(self) -> dict:
        return dataclasses.asdict(self)


def _outcome_cycles(
    profile: DemandProfile,
    outcome: PrefetchOutcome,
    t0: int,
    tm: TimingModel,
    dram_baseline: int,
    late_miss_cost: float,
    extra_metadata_dram: int = 0,
):
    """(cycles, counts) of a run described by ``outcome`` within the window."""
    base = profile.baseline_counts(t0)
    demand_miss_sel = ~outcome.demand_l2_hit
    miss_pos = profile.l2_pos[demand_miss_sel]
    in_win = miss_pos >= t0
    l2_misses = int(in_win.sum())
    dram_flags = ~outcome.demand_llc_hit
    dram_demand = int((dram_flags & in_win).sum())
    pf_dram = int(
        (outcome.pf_llc_in_dram & (outcome.pf_llc_in_pos >= t0)).sum()
    )
    late = int((outcome.demand_late & (profile.l2_pos >= t0)).sum())
    dram_total = dram_demand + pf_dram + extra_metadata_dram
    dram_pos = miss_pos[dram_flags]
    cycles = estimate_cycles(
        num_accesses=base["accesses"],
        l1_misses=base["l1_miss"],
        l2_misses_demand=l2_misses,
        dram_demand=dram_demand,
        dram_total=dram_total,
        dram_baseline=dram_baseline,
        late_useful=late,
        l2_miss_pos=miss_pos[in_win],
        dram_pos=dram_pos[dram_pos >= t0],
        cfg=profile.cfg,
        tm=tm,
        late_miss_cost=late_miss_cost,
    )
    counts = dict(
        l2_misses=l2_misses,
        dram_demand=dram_demand,
        pf_dram=pf_dram,
        dram_total=dram_total,
        late=late,
    )
    return cycles, counts


def _raw_late_cost(profile: DemandProfile, t0: int, tm: TimingModel) -> float:
    key = ("latecost", t0, tm)
    cache = getattr(profile, "_timing_cache", None)
    if cache is None:
        cache = profile._timing_cache = {}
    if key not in cache:
        base = profile.baseline_counts(t0)
        mp = profile.l2_miss_pos
        dp = mp[~profile.llc_hit]
        cache[key] = avg_miss_cost(
            l2_misses=base["l2_miss"],
            dram_misses=base["dram"],
            l2_miss_pos=mp[mp >= t0],
            dram_pos=dp[dp >= t0],
            cfg=profile.cfg,
            tm=tm,
        )
    return cache[key]


def evaluate(
    name: str,
    profile: DemandProfile,
    outcome: PrefetchOutcome,
    baseline_outcome: PrefetchOutcome,
    tm: TimingModel = TimingModel(),
    eval_from_pos: int = 0,
    issuer: int = 1,
) -> PrefetchMetrics:
    """Score issuer ``issuer`` within ``outcome`` against ``baseline_outcome``."""
    t0 = eval_from_pos
    base = profile.baseline_counts(t0)
    late_cost = _raw_late_cost(profile, t0, tm)

    # Baseline-run cycles/misses (cached across the prefetchers sharing it).
    key = ("basecycles", t0, tm, id(baseline_outcome))
    cache = getattr(profile, "_timing_cache", None)
    if cache is None:
        cache = profile._timing_cache = {}
    if key not in cache:
        meta_dram_b = baseline_outcome.metadata_bytes >> BLOCK_BITS
        cache[key] = _outcome_cycles(
            profile, baseline_outcome, t0, tm, base["dram"], late_cost, meta_dram_b
        )
    base_cycles, base_counts = cache[key]

    meta_dram = outcome.metadata_bytes >> BLOCK_BITS
    run_cycles, run_counts = _outcome_cycles(
        profile, outcome, t0, tm, base["dram"], late_cost, meta_dram
    )

    # Issuer-attributed prefetch quality.
    sel_l2 = profile.l2_pos >= t0
    sel_pf = (outcome.pf_pos >= t0) & (outcome.pf_issuer == issuer)
    useful_mask = outcome.demand_useful & sel_l2 & (
        outcome.demand_fill_issuer == issuer
    )
    useful = int(useful_mask.sum())
    late = int((outcome.demand_late & useful_mask).sum())
    issued = int(sel_pf.sum())
    redundant = int((outcome.pf_redundant & sel_pf).sum())
    overpred = int((outcome.pf_no_future & sel_pf).sum())
    early = int((outcome.pf_early & sel_pf).sum())

    baseline_misses = base_counts["l2_misses"]
    dram_b = base_counts["dram_total"]
    dram_r = run_counts["dram_total"]
    extra = (dram_r - dram_b) / max(dram_b, 1)
    meta = meta_dram / max(dram_b, 1)
    # Hardware filters L2-resident candidates before issue (a cache probe),
    # so redundant prefetches don't count toward the issue total.
    issued_eff = issued - redundant
    return PrefetchMetrics(
        name=name,
        accuracy=useful / max(issued_eff, 1),
        coverage=useful / max(baseline_misses, 1),
        speedup=base_cycles / max(run_cycles, 1e-9),
        ipc_baseline=base["accesses"] / max(base_cycles, 1e-9),
        ipc_prefetch=base["accesses"] / max(run_cycles, 1e-9),
        issued=issued,
        useful=useful,
        late=late,
        evicted_early=early,
        overpredicted=overpred,
        redundant=redundant,
        baseline_l2_misses=baseline_misses,
        extra_traffic=float(extra),
        metadata_traffic=float(meta),
        dram_demand=run_counts["dram_demand"],
        dram_total=dram_r,
    )


def geomean(xs) -> float:
    xs = np.asarray(list(xs), dtype=np.float64)
    xs = np.maximum(xs, 1e-12)
    return float(np.exp(np.log(xs).mean()))


def summarize_epochs(metrics) -> dict:
    """Drift-curve aggregates over an epoch-ordered metric sequence.

    Used by the streaming protocol (``repro_torch.stream.protocol``): per-epoch
    accuracy/coverage/speedup arrays plus the tail means from epoch 2 on
    (0-indexed epoch 1) — epoch 1 is always cold for cross-epoch
    prefetchers, so the tail is where lifecycle policies differentiate.
    """
    ms = list(metrics)
    if not ms:
        raise ValueError("summarize_epochs needs at least one epoch")
    coverage = [float(m.coverage) for m in ms]
    accuracy = [float(m.accuracy) for m in ms]
    speedup = [float(m.speedup) for m in ms]
    tail = slice(1, None) if len(ms) > 1 else slice(None)
    return {
        "coverage": coverage,
        "accuracy": accuracy,
        "speedup": speedup,
        "geomean_speedup": geomean(speedup),
        "mean_coverage": float(np.mean(coverage)),
        "mean_accuracy": float(np.mean(accuracy)),
        "tail_mean_coverage": float(np.mean(coverage[tail])),
        "tail_mean_accuracy": float(np.mean(accuracy[tail])),
        "tail_geomean_speedup": geomean(speedup[tail]),
    }
