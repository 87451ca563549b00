"""The paper's primary contribution, the AMC prefetcher system (PyTorch port
of ``repro.core``).

Public API
----------
  Experiment / ExperimentResult -- declarative (kernel x dataset x
                  prefetcher) evaluation grid with workload caching, on
                  the device the caller names (default the CUDA card)
  WorkloadSpec / build_workload -- declarative workload construction
                  (Algorithm-1 AMC session wiring included)
  registry      -- ``@register_prefetcher`` + ``get_prefetcher``: AMC and
                  every baseline of the JAX package (the seven Table I
                  baselines, ``nextline2``, ``ideal``) by name

Subpackages:
  amc          -- the Access-to-Miss Correlation prefetcher
  prefetchers  -- the evaluated baselines
  driver       -- the workload driver tying apps, traces, memsim and
                  prefetchers together
  experiment   -- the Experiment grid and per-stream scoring
  exec         -- parallel execution engine: process-pool grid scheduler,
                  the content-addressed workload artifact cache, sharded
                  paper-scale traces and the stage timers
  obs          -- spans, the metrics registry and run manifests

``Experiment(workloads=[...])`` also takes the evolving-graph streams of
:mod:`repro_torch.stream` (``StreamSpec``) and the multi-tenant serving
scenarios of :mod:`repro_torch.serve` (``ServeSpec``).
"""
from repro_torch.core.driver import WorkloadSpec, WorkloadTrace, build_workload
from repro_torch.core.exec.artifacts import ArtifactCache
from repro_torch.core.obs import MetricsRegistry, RunTrace, Span, Tracer, trace
from repro_torch.core.experiment import (
    CellResult,
    Experiment,
    ExperimentResult,
    WorkloadCache,
    score_prefetcher,
    score_prefetchers_batched,
)
from repro_torch.core.registry import (
    Prefetcher,
    PrefetcherSpec,
    get_prefetcher,
    list_prefetchers,
    register_prefetcher,
    resolve_prefetchers,
)

__all__ = [
    "ArtifactCache",
    "MetricsRegistry",
    "RunTrace",
    "Span",
    "Tracer",
    "trace",
    "WorkloadSpec",
    "WorkloadTrace",
    "build_workload",
    "CellResult",
    "Experiment",
    "ExperimentResult",
    "WorkloadCache",
    "score_prefetcher",
    "score_prefetchers_batched",
    "Prefetcher",
    "PrefetcherSpec",
    "get_prefetcher",
    "list_prefetchers",
    "register_prefetcher",
    "resolve_prefetchers",
]
