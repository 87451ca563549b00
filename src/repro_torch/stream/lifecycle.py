"""Cross-epoch AMC correlation-table lifecycle (ported from
``repro.stream.lifecycle``; host numpy, as in the JAX package).

The paper carries AMC's metadata across the §VI two-run boundary implicitly
(the second run replays what the first recorded).  Over a long update
stream the policy governing that carry decides accuracy and coverage as
the graph drifts.  :class:`TableLifecycle` owns one
:class:`~repro_torch.core.amc.storage.AMCStorage` across an epoch sequence and
applies one of four boundary policies between epochs:

``persist``
    The paper behavior generalized: ``swap()`` at every boundary — epoch
    ``e`` prefetches from what epoch ``e-1`` recorded, stale entries and
    all.  Coverage degrades gracefully with cumulative churn.
``reset``
    Cold tables each epoch (``AMC.end()`` + ``AMC.init()`` per version):
    the no-cross-epoch-memory baseline.  AMC records but never replays, so
    per-epoch metrics equal an independent cold run of that epoch
    (property-tested).
``age``
    ``swap_retaining(max_age)``: iterations not re-recorded keep their old
    table as an aged fallback for up to ``max_age`` epochs — trades
    staleness risk for coverage on epochs that run fewer iterations.
``invalidate_changed``
    ``swap()`` then drop entries whose trigger vertex was touched by the
    inbound update batch — their recorded miss streams describe a
    neighborhood that no longer exists.  Trades coverage for accuracy
    under churn.

Boundary work is timed under the ``table_carry`` stage, and every
boundary emits an
:class:`EpochTableReport` with per-epoch lookup hit/miss/staleness counter
deltas — the drift observability the scenario engine is for.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.amc.api import AMCSession
from repro_torch.core.amc.storage import AMCStorage
from repro_torch.core.exec.timers import stage

LIFECYCLE_POLICIES = ("persist", "reset", "age", "invalidate_changed")


@dataclasses.dataclass(frozen=True)
class EpochTableReport:
    """Table accounting for one scored epoch + its outbound boundary."""

    epoch: int
    policy: str
    lookup_hits: int  # iteration lookups that found a table this epoch
    lookup_misses: int
    stale_hits: int  # hits on tables older than one epoch
    invalidated_entries: int  # dropped at the boundary (invalidate_changed)
    aged_out_tables: int  # dropped at the boundary (age cap)
    carried_tables: int  # prefetch-space tables entering the next epoch
    carried_entries: int
    graph_version: int

    def row(self) -> dict:
        return dataclasses.asdict(self)


class TableLifecycle:
    """Carries one AMC storage across an epoch sequence under a policy."""

    def __init__(
        self,
        policy: str,
        capacity_bytes: int,
        max_age: int = 2,
        session: Optional[AMCSession] = None,
    ):
        if policy not in LIFECYCLE_POLICIES:
            raise ValueError(
                f"unknown lifecycle policy {policy!r}; "
                f"available: {list(LIFECYCLE_POLICIES)}"
            )
        self.policy = policy
        self.capacity_bytes = int(capacity_bytes)
        self.max_age = int(max_age)
        self.session = session
        self.storage = AMCStorage(self.capacity_bytes)
        self.reports = []
        self._snap = self._counters()

    def _counters(self) -> dict:
        s = self.storage
        return dict(
            lookup_hits=s.lookup_hits,
            lookup_misses=s.lookup_misses,
            stale_hits=s.stale_hits,
            invalidated_entries=s.invalidated_entries,
            aged_out_tables=s.aged_out_tables,
        )

    def begin_epoch(self, epoch: int) -> AMCStorage:
        """Snapshot counters; returns the storage to score this epoch with."""
        self._snap = self._counters()
        return self.storage

    def end_epoch(
        self, epoch: int, changed_vids: Optional[np.ndarray] = None
    ) -> EpochTableReport:
        """Apply the boundary policy after scoring epoch ``epoch``.

        ``changed_vids`` is the invalidation set of the *inbound* batch of
        epoch ``epoch + 1`` (``SnapshotSequence.changed_vertices``); only
        the ``invalidate_changed`` policy consumes it.
        """
        before, after = self._snap, self._counters()
        with stage("table_carry"):
            if self.policy == "reset":
                # AMC.end()/AMC.init() per graph version: drop everything.
                self.storage = AMCStorage(self.capacity_bytes)
            elif self.policy == "age":
                self.storage.swap_retaining(self.max_age)
            else:  # persist | invalidate_changed: the paper's role swap
                self.storage.swap()
                if self.policy == "invalidate_changed" and changed_vids is not None:
                    self.storage.invalidate_triggers(changed_vids)
            if self.session is not None:
                self.session.new_graph_version()
        boundary = self._counters()
        report = EpochTableReport(
            epoch=epoch,
            policy=self.policy,
            lookup_hits=after["lookup_hits"] - before["lookup_hits"],
            lookup_misses=after["lookup_misses"] - before["lookup_misses"],
            stale_hits=after["stale_hits"] - before["stale_hits"],
            invalidated_entries=boundary["invalidated_entries"]
            - after["invalidated_entries"],
            aged_out_tables=boundary["aged_out_tables"] - after["aged_out_tables"],
            carried_tables=len(self.storage.prefetching),
            carried_entries=int(
                sum(t.num_entries for t in self.storage.prefetching.values())
            ),
            graph_version=(
                self.session.graph_version if self.session is not None else epoch + 1
            ),
        )
        self.reports.append(report)
        return report


__all__ = ["EpochTableReport", "LIFECYCLE_POLICIES", "TableLifecycle"]
