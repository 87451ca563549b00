"""Calibrated miss-penalty IPC model (relative speedups, not cycle accuracy).

    cycles = exec_cycles
           + (L1 misses) * L2_lat
           + (L2 misses hitting LLC) * LLC_lat / MLP_llc
           + (DRAM accesses)          * DRAM_lat_eff / MLP_dram
           + (late useful prefetches) * DRAM_lat_eff * late_fraction

MLP is *measured* from miss clustering (average number of concurrent misses
within an MSHR-sized lookahead window, capped at the MSHR count), which is
how graph kernels actually extract memory-level parallelism on an OoO core.
Extra prefetch traffic raises effective DRAM latency through a bandwidth
queueing term — this is what penalizes the 958%-overtraffic prefetchers
(ISB) in the speedup plot exactly as in the paper.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.memsim.config import HierarchyConfig


@dataclasses.dataclass(frozen=True)
class TimingModel:
    cycles_per_access: float = 0.75  # core work per memory reference (4-wide)
    l2_hit_penalty: float = 3.0  # un-hidden L2 hit latency per L1 miss (OoO)
    mlp_window: int = 48  # accesses of lookahead for MLP measurement
    mlp_cap_llc: float = 8.0  # dependency-chain-limited overlap at LLC
    mlp_cap_dram: float = 6.0  # and at DRAM (1ch DDR4 bandwidth bound)
    late_fraction: float = 0.5  # fraction of avoided miss cost still paid
    bw_sensitivity: float = 0.12  # queueing: extra latency per 1x extra traffic


def measure_mlp(miss_pos: np.ndarray, window: int, cap: float) -> float:
    """Average number of misses in flight (clustering within ``window``).

    Subsamples above 1M misses — the estimate is a mean over miss sites.
    """
    if len(miss_pos) < 2:
        return 1.0
    pos = np.sort(miss_pos)
    sample = pos[:: max(len(pos) // 1_000_000, 1)]
    hi = np.searchsorted(pos, sample + window, side="right")
    lo = np.searchsorted(pos, sample, side="left")
    concurrent = hi - lo
    return float(np.clip(concurrent.mean(), 1.0, cap))


def estimate_cycles(
    num_accesses: int,
    l1_misses: int,
    l2_misses_demand: int,
    dram_demand: int,
    dram_total: int,
    dram_baseline: int,
    late_useful: int,
    l2_miss_pos: np.ndarray,
    dram_pos: np.ndarray,
    cfg: HierarchyConfig,
    tm: TimingModel = TimingModel(),
    late_miss_cost: float = 0.0,
    mlp_llc: float | None = None,
    mlp_dram: float | None = None,
) -> float:
    """``late_miss_cost``: average cost of the miss a late prefetch avoided,
    computed from the *baseline* run (a late prefetch can never be worse than
    the miss it replaced).  ``mlp_llc``/``mlp_dram`` accept precomputed MLP
    values (the streaming scorer measures them from spilled position streams
    with the exact :func:`measure_mlp` arithmetic) — ``None`` measures them
    from the in-memory position arrays as before."""
    if mlp_llc is None:
        mlp_llc = measure_mlp(l2_miss_pos, tm.mlp_window, tm.mlp_cap_llc)
    if mlp_dram is None:
        mlp_dram = measure_mlp(dram_pos, tm.mlp_window, tm.mlp_cap_dram)
    # Bandwidth queueing from extra (prefetch + metadata) DRAM traffic.
    extra_ratio = max(dram_total / max(dram_baseline, 1) - 1.0, 0.0)
    dram_eff = cfg.dram_latency * (1.0 + tm.bw_sensitivity * extra_ratio)

    exec_cycles = tm.cycles_per_access * num_accesses
    l2_cycles = tm.l2_hit_penalty * l1_misses
    llc_hits = max(l2_misses_demand - dram_demand, 0)
    llc_cycles = cfg.llc.latency * llc_hits / mlp_llc
    dram_cycles = dram_eff * dram_demand / mlp_dram
    late_cycles = tm.late_fraction * late_miss_cost * late_useful
    return exec_cycles + l2_cycles + llc_cycles + dram_cycles + late_cycles


def avg_miss_cost(
    l2_misses: int,
    dram_misses: int,
    l2_miss_pos: np.ndarray,
    dram_pos: np.ndarray,
    cfg: HierarchyConfig,
    tm: TimingModel = TimingModel(),
    mlp_llc: float | None = None,
    mlp_dram: float | None = None,
) -> float:
    """Average per-L2-miss stall cost of a run (used as the avoided cost)."""
    if l2_misses <= 0:
        return 0.0
    if mlp_llc is None:
        mlp_llc = measure_mlp(l2_miss_pos, tm.mlp_window, tm.mlp_cap_llc)
    if mlp_dram is None:
        mlp_dram = measure_mlp(dram_pos, tm.mlp_window, tm.mlp_cap_dram)
    llc_hits = max(l2_misses - dram_misses, 0)
    total = (
        cfg.llc.latency * llc_hits / mlp_llc
        + cfg.dram_latency * dram_misses / mlp_dram
    )
    return total / l2_misses
