"""Multi-epoch evolving-graph streaming subsystem (ported from
``repro.stream``).

Turns the paper's §VI two-snapshot protocol into a scenario engine: churn
models generate deterministic batched update streams (:mod:`updates`),
delta application yields an epoch sequence of CSR snapshots with churn
stats (:mod:`snapshots`), the AMC correlation tables are carried across
epoch boundaries under pluggable lifecycle policies (:mod:`lifecycle`),
and :mod:`protocol` ties it into the ``Experiment`` grid — per-epoch
traces cached as workload artifacts, per-epoch metrics, drift-curve
aggregates.

The update/snapshot layers depend only on the graph substrate; the
lifecycle and protocol layers (which pull in the AMC core and the
execution engine) load lazily on first attribute access, so
``repro_torch.graphs`` can build on snapshots without a circular import.
"""
from repro_torch.stream.snapshots import (
    EpochStats,
    SnapshotSequence,
    apply_delta,
    snapshot_sequence,
)
from repro_torch.stream.updates import (
    CHURN_MODELS,
    CommunityChurn,
    DeltaBatch,
    PreferentialGrowth,
    SlidingWindow,
    UniformChurn,
    UpdateStream,
)

_LAZY = {
    "LIFECYCLE_POLICIES": "repro_torch.stream.lifecycle",
    "TableLifecycle": "repro_torch.stream.lifecycle",
    "EpochTableReport": "repro_torch.stream.lifecycle",
    "EpochCell": "repro_torch.stream.protocol",
    "StreamEpochSpec": "repro_torch.stream.protocol",
    "StreamResult": "repro_torch.stream.protocol",
    "StreamSpec": "repro_torch.stream.protocol",
    "drift_payload": "repro_torch.stream.protocol",
    "run_stream": "repro_torch.stream.protocol",
    "score_stream": "repro_torch.stream.protocol",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))


__all__ = [
    "CHURN_MODELS",
    "CommunityChurn",
    "DeltaBatch",
    "EpochCell",
    "EpochStats",
    "EpochTableReport",
    "LIFECYCLE_POLICIES",
    "PreferentialGrowth",
    "SlidingWindow",
    "SnapshotSequence",
    "StreamEpochSpec",
    "StreamResult",
    "StreamSpec",
    "TableLifecycle",
    "UniformChurn",
    "UpdateStream",
    "apply_delta",
    "drift_payload",
    "run_stream",
    "score_stream",
    "snapshot_sequence",
]
