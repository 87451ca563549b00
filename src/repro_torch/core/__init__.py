"""The paper's primary contribution, the AMC prefetcher system (PyTorch port).

Public API ported so far:
  WorkloadSpec / build_workload -- declarative workload construction
                  (Algorithm-1 AMC session wiring included)
  score_prefetcher / score_prefetchers_batched -- composite scoring
  registry      -- ``@register_prefetcher`` + ``get_prefetcher`` /
                  ``resolve_prefetchers`` (AMC, VLDP, Bingo so far)
"""
from repro_torch.core.driver import WorkloadSpec, WorkloadTrace, build_workload
from repro_torch.core.experiment import score_prefetcher, score_prefetchers_batched
from repro_torch.core.registry import (
    Prefetcher,
    PrefetcherSpec,
    get_prefetcher,
    list_prefetchers,
    register_prefetcher,
    resolve_prefetchers,
)

__all__ = [
    "Prefetcher",
    "PrefetcherSpec",
    "WorkloadSpec",
    "WorkloadTrace",
    "build_workload",
    "get_prefetcher",
    "list_prefetchers",
    "register_prefetcher",
    "resolve_prefetchers",
    "score_prefetcher",
    "score_prefetchers_batched",
]
