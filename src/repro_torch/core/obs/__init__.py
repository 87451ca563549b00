"""Structured run telemetry: spans, metrics, and run manifests (ported
from ``repro.core.obs``; the span model and attribute conventions are the
JAX package's, ``docs/OBSERVABILITY.md``)."""

from repro_torch.core.obs.manifest import git_sha, run_manifest
from repro_torch.core.obs.metrics import (
    MetricsRegistry,
    histogram_quantile,
    merge_snapshots,
)
from repro_torch.core.obs.spans import (
    SPAN_DIR_ENV,
    TRACE_ID_ENV,
    TRACE_SCHEMA,
    RunTrace,
    Span,
    Tracer,
    collect_stages,
    current_metrics,
    current_tracer,
    flush_worker_metrics,
    inc,
    metrics_registry,
    observe,
    record,
    set_gauge,
    span,
    stage,
    trace,
    tracing,
)

__all__ = [
    "MetricsRegistry",
    "RunTrace",
    "SPAN_DIR_ENV",
    "Span",
    "TRACE_ID_ENV",
    "TRACE_SCHEMA",
    "Tracer",
    "collect_stages",
    "current_metrics",
    "current_tracer",
    "flush_worker_metrics",
    "git_sha",
    "histogram_quantile",
    "inc",
    "merge_snapshots",
    "metrics_registry",
    "observe",
    "record",
    "run_manifest",
    "set_gauge",
    "span",
    "stage",
    "trace",
    "tracing",
]
