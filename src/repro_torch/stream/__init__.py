"""Evolving-graph update streams and epoch snapshots (ported from
``repro.stream``).

So far the part the §VI two-run protocol needs: the uniform vertex-churn
model and the snapshot sequence it induces.  The other churn models, the
cross-epoch table lifecycle and the stream protocol come with the
streaming slice of the port.
"""
from repro_torch.stream.snapshots import (
    EpochStats,
    SnapshotSequence,
    apply_delta,
    snapshot_sequence,
)
from repro_torch.stream.updates import DeltaBatch, UniformChurn, UpdateStream

__all__ = [
    "DeltaBatch",
    "EpochStats",
    "SnapshotSequence",
    "UniformChurn",
    "UpdateStream",
    "apply_delta",
    "snapshot_sequence",
]
