"""Structured run telemetry: spans, metrics, and run manifests (ported
from ``repro.core.obs``; the span model and attribute conventions are the
JAX package's, ``docs/OBSERVABILITY.md``)."""

from repro_torch.core.obs.manifest import run_manifest
from repro_torch.core.obs.metrics import MetricsRegistry, merge_snapshots
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
    record,
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
    "inc",
    "merge_snapshots",
    "metrics_registry",
    "record",
    "run_manifest",
    "span",
    "stage",
    "trace",
    "tracing",
]
