"""Trace-driven memory-hierarchy simulator (PyTorch port of ``repro.memsim``).

Two-pass functional simulation, as in the JAX package: a demand pass over
the full stream (L1 → L2 → LLC, by default one launch of kernel K2 that
emits each access's hit level), then per-prefetcher re-simulation of L2 and
LLC with the prefetch stream merged in (kernel K1, one launch per level for
a whole family of prefetchers).  Engines and their switch live in
:mod:`repro_torch.memsim.engine`; timing is the calibrated miss-penalty IPC
model of :mod:`repro_torch.memsim.timing`.
"""
from repro_torch.memsim.config import CacheLevelConfig, HierarchyConfig, PAPER, SCALED
from repro_torch.memsim.engine import (
    ENGINES,
    CacheState,
    cache_pass,
    cache_pass_batch,
    current_engine,
    set_engine,
    use_engine,
)
from repro_torch.memsim.fused import fused_cache_pass, fused_cache_pass_batch
from repro_torch.memsim.scan_cache import classify_prefetch_events
from repro_torch.memsim.hierarchy import (
    DemandProfile,
    DemandState,
    PrefetchOutcome,
    simulate_demand,
    simulate_demand_batch,
    simulate_with_prefetch,
    simulate_with_prefetch_batch,
)
from repro_torch.memsim.timing import TimingModel, estimate_cycles
from repro_torch.memsim.metrics import PrefetchMetrics, evaluate, geomean, summarize_epochs

__all__ = [
    "CacheLevelConfig",
    "CacheState",
    "ENGINES",
    "HierarchyConfig",
    "PAPER",
    "SCALED",
    "cache_pass",
    "cache_pass_batch",
    "classify_prefetch_events",
    "current_engine",
    "fused_cache_pass",
    "fused_cache_pass_batch",
    "set_engine",
    "use_engine",
    "DemandProfile",
    "DemandState",
    "PrefetchOutcome",
    "simulate_demand",
    "simulate_demand_batch",
    "simulate_with_prefetch",
    "simulate_with_prefetch_batch",
    "TimingModel",
    "estimate_cycles",
    "PrefetchMetrics",
    "evaluate",
    "geomean",
    "summarize_epochs",
]
