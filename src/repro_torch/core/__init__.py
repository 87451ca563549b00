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

The names below resolve lazily through ``__getattr__``: importing a
submodule (``repro_torch.core.obs.spans``, which the model path imports)
loads neither the workload driver nor the experiment grid.
"""
import importlib

_EXPORTS = {
    "repro_torch.core.driver": ("WorkloadSpec", "WorkloadTrace", "build_workload"),
    "repro_torch.core.exec.artifacts": ("ArtifactCache",),
    "repro_torch.core.obs": ("MetricsRegistry", "RunTrace", "Span", "Tracer", "trace"),
    "repro_torch.core.experiment": ("CellResult", "Experiment", "ExperimentResult",
                                    "WorkloadCache", "score_prefetcher",
                                    "score_prefetchers_batched"),
    "repro_torch.core.registry": ("Prefetcher", "PrefetcherSpec", "get_prefetcher",
                                  "list_prefetchers", "register_prefetcher",
                                  "resolve_prefetchers"),
}
_HOME = {name: module for module, names in _EXPORTS.items() for name in names}

__all__ = [name for names in _EXPORTS.values() for name in names]


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_HOME[name]), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
