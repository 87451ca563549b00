"""Stream protocol: multi-epoch evolving-graph evaluation on the
Experiment engine (ported from ``repro.stream.protocol``).

A :class:`StreamSpec` declares one evolving-graph scenario — kernel,
dataset, churn model, epoch count, AMC table-lifecycle policy — and plugs
into the existing machinery like a :class:`~repro_torch.core.driver.WorkloadSpec`:

- **Per-epoch traces, built once, cached.**  The spec expands into E
  :class:`StreamEpochSpec` workload specs (hashable, content-addressable),
  each building the kernel run on snapshot ``g_e`` of the deterministic
  :func:`~repro_torch.stream.snapshots.snapshot_sequence`.  They duck-type
  ``WorkloadSpec`` everywhere it matters, so the
  :class:`~repro_torch.core.exec.artifacts.ArtifactCache` persists them and the
  parallel scheduler materializes epochs of one stream as independent
  chunks across the pool.
- **Shared address layout.**  All epochs are traced in one address space
  (``num_edges`` = the stream's maximum), so a vertex's property/frontier
  addresses — and therefore AMC's recorded correlations — are
  commensurable across the whole stream.  The §VI caveat generalizes: one
  root, present in every epoch, is picked for the traversal kernels.
- **Epoch = graph version.**  Each epoch trace is a single AMC epoch with
  the iteration index as the within-epoch key: epoch ``e`` replays what
  epoch ``e-1`` recorded (BFS level *j* against the previous version's
  level *j*), exactly the two-run protocol stretched to E runs.  The
  :class:`~repro_torch.stream.lifecycle.TableLifecycle` owns the carry policy at
  each boundary; stateless baselines score each epoch independently.
- **Drift curves.**  :func:`drift_payload` aggregates per-epoch metrics
  against the sequence's overlap/churn statistics into the JAX package's
  ``stream-drift`` JSON schema.

The scoring path is deliberately identical for serial and parallel runs —
workers only ever *materialize* epoch traces; the lifecycle walk happens
in the parent, so ``workers=N`` results are byte-identical to serial.

PyTorch port: graph construction, trace emission, the memo keys and the
lifecycle walk are host numpy, as in the JAX package; each epoch's kernel
run and every cache pass run on the device the caller names (``device=``
on :meth:`StreamEpochSpec.build` and :func:`run_stream`, default the CUDA
card).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.apps import get_kernel, has_kernel, list_kernels
from repro_torch.apps.trace import TraceConfig
from repro_torch.core.driver import (
    WorkloadTrace,
    _build_workload,
    make_session,
)
from repro_torch.core.exec.timers import stage
from repro_torch.core.obs import spans as obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import DATASETS, make_dataset
from repro_torch.memsim import SCALED, HierarchyConfig, PrefetchMetrics
from repro_torch.memsim.metrics import summarize_epochs
from repro_torch.stream.lifecycle import LIFECYCLE_POLICIES, TableLifecycle
from repro_torch.stream.snapshots import SnapshotSequence, snapshot_sequence


def _validate_elem_sizes(target: int, frontier: int) -> None:
    if target < 1 or frontier < 1:
        raise ValueError("element sizes must be >= 1 byte")
    if target % frontier:
        raise ValueError(
            f"target_elem_size ({target}) must be an integer multiple of "
            f"frontier_elem_size ({frontier})"
        )


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Declarative multi-epoch evolving-graph scenario.

    Epoch traces are lifecycle-agnostic (the policy only steers scoring),
    so streams differing only in ``lifecycle`` share every cached epoch
    trace — comparing ``persist`` vs ``reset`` costs one extra scoring
    pass, not a rebuild.
    """

    kernel: str
    dataset: str
    churn: object  # a churn model from repro_torch.stream.updates
    epochs: int = 4
    lifecycle: str = "persist"
    max_age: int = 2  # for the "age" policy
    hierarchy: HierarchyConfig = SCALED
    seed: int = 0
    target_elem_size: int = 8
    frontier_elem_size: int = 1

    # Duck-typing marker: Experiment routes these through the stream
    # protocol without importing it at declaration time.
    is_stream: ClassVar[bool] = True

    def __post_init__(self):
        if self.epochs < 2:
            raise ValueError(f"a stream needs >= 2 epochs, got {self.epochs}")
        if self.lifecycle not in LIFECYCLE_POLICIES:
            raise ValueError(
                f"unknown lifecycle {self.lifecycle!r}; "
                f"available: {list(LIFECYCLE_POLICIES)}"
            )
        if not hasattr(self.churn, "generate"):
            raise TypeError(
                f"churn must be a churn model (see repro_torch.stream.updates); "
                f"got {self.churn!r}"
            )
        _validate_elem_sizes(self.target_elem_size, self.frontier_elem_size)

    def validate_names(self) -> None:
        if not has_kernel(self.kernel):
            raise ValueError(
                f"unknown kernel {self.kernel!r}; "
                f"available: {sorted(list_kernels())}"
            )
        if self.dataset not in DATASETS:
            raise ValueError(
                f"unknown dataset {self.dataset!r}; available: {sorted(DATASETS)}"
            )

    def epoch_specs(self) -> List["StreamEpochSpec"]:
        return [
            StreamEpochSpec(
                kernel=self.kernel,
                dataset=self.dataset,
                churn=self.churn,
                epochs=self.epochs,
                epoch=e,
                hierarchy=self.hierarchy,
                seed=self.seed,
                target_elem_size=self.target_elem_size,
                frontier_elem_size=self.frontier_elem_size,
            )
            for e in range(self.epochs)
        ]

    def sequence(self) -> SnapshotSequence:
        """The (memoized) snapshot sequence behind this stream."""
        return _sequence_for(
            self.kernel, self.dataset, self.churn, self.epochs, self.seed
        )


@dataclasses.dataclass(frozen=True)
class StreamEpochSpec:
    """One epoch of a stream as a cacheable, schedulable workload spec.

    Field-compatible with :class:`~repro_torch.core.driver.WorkloadSpec` where
    the engine cares (kernel/dataset/hierarchy/seed/element sizes), plus
    the stream identity (churn, total epochs) and the epoch index — all of
    which land in the artifact content hash, so epoch traces are
    content-addressed like any workload.
    """

    kernel: str
    dataset: str
    churn: object
    epochs: int
    epoch: int
    hierarchy: HierarchyConfig = SCALED
    seed: int = 0
    target_elem_size: int = 8
    frontier_elem_size: int = 1

    def __post_init__(self):
        if not (0 <= self.epoch < self.epochs):
            raise ValueError(f"epoch {self.epoch} outside [0, {self.epochs})")
        _validate_elem_sizes(self.target_elem_size, self.frontier_elem_size)

    def validate_names(self) -> None:
        StreamSpec.validate_names(self)  # same name checks

    def build(self, device: DeviceLike = None) -> WorkloadTrace:
        """Run the kernel on snapshot ``epoch`` on ``device`` (default the
        CUDA card) and trace it in the stream's shared address layout
        (timed as ``trace_epoch``)."""
        self.validate_names()
        dev = resolve_device(device)
        with obs.span(
            "build_epoch",
            kernel=self.kernel,
            dataset=self.dataset,
            epoch=self.epoch,
            churn=self.churn,
        ), stage("trace_epoch"):
            seq = _sequence_for(
                self.kernel, self.dataset, self.churn, self.epochs, self.seed
            )
            run = _run_epoch(self.kernel, seq, self.epoch, dev)
            cfg_trace = TraceConfig(
                num_vertices=seq.base.num_vertices, num_edges=seq.max_edges
            )
            return _build_workload(
                self,
                runs=[run],
                cfg_trace=cfg_trace,
                epoch_mode="single",
                device=dev,
            )

    def content_key(self) -> dict:
        """Identity of the trace this spec *builds*, not how it was declared.

        Everything the emitted trace is determined by: the epoch's graph
        content (CSR arrays + presence mask, as a SHA-256), the shared
        root, the stream-wide address layout, and the kernel/hierarchy/
        element-size configuration.  The artifact cache keys content-keyed
        specs on this document, so an epoch whose graph the churn model
        left unchanged — or the same graph version reached through
        different stream parameters — resolves to the *same* artifact and
        is reused instead of re-emitted (delta-aware trace reuse).
        """
        ks = get_kernel(self.kernel)
        seq = _sequence_for(
            self.kernel, self.dataset, self.churn, self.epochs, self.seed
        )
        key = _seq_key(self.kernel, self.dataset, self.churn, self.epochs, self.seed)
        return {
            "kind": "stream-epoch",
            "kernel": self.kernel,
            "direction": ks.direction,
            "hierarchy": dataclasses.asdict(self.hierarchy),
            "elem_sizes": [self.target_elem_size, self.frontier_elem_size],
            "layout": [int(seq.base.num_vertices), int(seq.max_edges)],
            "root": _epoch_root(self.kernel, seq),
            "graph_sha256": _epoch_fingerprint(key, seq, self.epoch),
        }


# Snapshot sequences are deterministic in (kernel's weightedness, dataset,
# churn, epochs, seed); memoize per process so E epoch builds and the
# scoring walk share one sequence.
_SEQ_CACHE: Dict[tuple, SnapshotSequence] = {}

# Per-epoch graph fingerprints, memoized alongside the sequence: hashing
# the CSR arrays costs milliseconds but runs once per (sequence, epoch)
# per process, not once per cache probe.
_FP_CACHE: Dict[tuple, str] = {}


def _seq_key(kernel: str, dataset: str, churn, epochs: int, seed: int) -> tuple:
    return (dataset, get_kernel(kernel).weighted, churn, epochs, seed)


def _sequence_for(
    kernel: str, dataset: str, churn, epochs: int, seed: int
) -> SnapshotSequence:
    key = _seq_key(kernel, dataset, churn, epochs, seed)
    if key not in _SEQ_CACHE:
        base = make_dataset(dataset, weighted=get_kernel(kernel).weighted)
        _SEQ_CACHE[key] = snapshot_sequence(base, churn, epochs, seed=seed)
    return _SEQ_CACHE[key]


def _epoch_fingerprint(seq_key: tuple, seq: SnapshotSequence, epoch: int) -> str:
    """SHA-256 over epoch ``epoch``'s graph content: CSR offsets,
    neighbors, weights (when present) and the vertex presence mask —
    exactly the inputs the kernel run sees (host numpy arrays in the port
    too: graphs are built on the host)."""
    key = (seq_key, epoch)
    if key not in _FP_CACHE:
        g = seq.graphs[epoch]
        h = hashlib.sha256()
        for arr in (g.offsets, g.neighbors, g.weights, seq.masks[epoch]):
            if arr is None:
                h.update(b"|none")
                continue
            a = np.ascontiguousarray(arr)
            h.update(f"|{a.dtype}{a.shape}|".encode())
            h.update(a.tobytes())
        _FP_CACHE[key] = h.hexdigest()
    return _FP_CACHE[key]


def _epoch_root(kernel: str, seq: SnapshotSequence) -> Optional[int]:
    """The stream's shared traversal root (None for rootless kernels).

    The paper's BFS caveat, stretched to E epochs: one root, present in
    every epoch, so the traversals stay correlated end to end.
    """
    ks = get_kernel(kernel)
    if not ks.needs_root:
        return None
    from repro_torch.apps.bfs import pick_root

    always = np.logical_and.reduce(seq.masks)
    return int(
        pick_root(seq.graphs[0], always if always.any() else seq.masks[0])
    )


def _run_epoch(kernel: str, seq: SnapshotSequence, epoch: int, device):
    """One kernel run on snapshot ``epoch`` on ``device`` (shared root for
    traversals)."""
    ks = get_kernel(kernel)
    return ks.run(
        seq.graphs[epoch],
        present_mask=seq.masks[epoch],
        root=_epoch_root(kernel, seq),
        device=device,
    )


# --------------------------------------------------------------- scoring


@dataclasses.dataclass(frozen=True)
class EpochCell:
    """One (epoch, prefetcher) score within a stream."""

    epoch: int
    prefetcher: str
    lifecycle: Optional[str]  # None for stateless (per-epoch) baselines
    metrics: PrefetchMetrics
    spec: StreamEpochSpec


def _is_amc_generator(gen) -> bool:
    from repro_torch.core.amc.prefetcher import AMCPrefetcher

    return isinstance(getattr(gen, "__self__", None), AMCPrefetcher)


def score_stream(
    spec: StreamSpec,
    prefetchers: Sequence[Tuple[str, object]],
    traces: Sequence[WorkloadTrace],
) -> List[EpochCell]:
    """Score every prefetcher over the epoch sequence.

    AMC-family generators (bound ``AMCPrefetcher.generate`` methods) walk
    the epochs with one carried :class:`TableLifecycle`; everything else is
    stateless and scores each epoch independently.  Deterministic given the
    traces — the serial/parallel parity of the stream protocol rests here.
    """
    from repro_torch.core.experiment import score_prefetcher

    seq = spec.sequence()
    epoch_specs = spec.epoch_specs()
    cells: List[EpochCell] = []
    for name, gen in prefetchers:
        if _is_amc_generator(gen):
            cfg = gen.__self__.config
            # A fresh session per scoring walk: the lifecycle advances its
            # graph-version counter, and the cached trace's session must
            # stay pristine so repeat runs score identically.
            lc = TableLifecycle(
                spec.lifecycle,
                capacity_bytes=int(cfg.storage_fraction * traces[0].input_bytes),
                max_age=spec.max_age,
                session=make_session(spec, traces[0].cfg_trace),
            )
            for e, trace in enumerate(traces):
                with obs.span(
                    "stream_epoch",
                    epoch=e,
                    prefetcher=name,
                    lifecycle=spec.lifecycle,
                    churn=spec.churn,
                ):
                    storage = lc.begin_epoch(e)

                    def with_carry(workload, _gen=gen, _storage=storage):
                        return _gen(workload, storage=_storage)

                    m = score_prefetcher(trace, name, with_carry)
                    changed = (
                        seq.changed_vertices(e + 1)
                        if e + 1 < spec.epochs
                        else None
                    )
                    report = lc.end_epoch(e, changed_vids=changed)
                    m.info.update(lifecycle=spec.lifecycle, table=report.row())
                cells.append(
                    EpochCell(
                        epoch=e,
                        prefetcher=name,
                        lifecycle=spec.lifecycle,
                        metrics=m,
                        spec=epoch_specs[e],
                    )
                )
        else:
            for e, trace in enumerate(traces):
                with obs.span(
                    "stream_epoch", epoch=e, prefetcher=name, churn=spec.churn
                ):
                    m = score_prefetcher(trace, name, gen)
                cells.append(
                    EpochCell(
                        epoch=e,
                        prefetcher=name,
                        lifecycle=None,
                        metrics=m,
                        spec=epoch_specs[e],
                    )
                )
    return cells


def run_stream(
    spec: StreamSpec,
    prefetchers,
    cache=None,
    workers: Optional[int] = None,
    verbose: bool = False,
    device: DeviceLike = None,
) -> "StreamResult":
    """Convenience wrapper: one stream through the Experiment engine on
    ``device`` (default the CUDA card)."""
    from repro_torch.core.experiment import Experiment

    exp = Experiment(
        workloads=[spec], prefetchers=prefetchers, cache=cache, device=device
    )
    result = exp.run(workers=workers, verbose=verbose)
    return StreamResult(
        spec=spec,
        sequence=spec.sequence(),
        cells=[
            EpochCell(
                epoch=c.epoch,
                prefetcher=c.prefetcher,
                lifecycle=c.lifecycle,
                metrics=c.metrics,
                spec=c.spec,
            )
            for c in result.cells
        ],
    )


@dataclasses.dataclass
class StreamResult:
    """Per-epoch cells + the snapshot sequence they were scored against."""

    spec: StreamSpec
    sequence: SnapshotSequence
    cells: List[EpochCell]

    def epoch_metrics(self, prefetcher: str) -> List[PrefetchMetrics]:
        out = [c.metrics for c in self.cells if c.prefetcher == prefetcher]
        if not out:
            raise KeyError(
                f"prefetcher {prefetcher!r} not in stream result; "
                f"have {sorted({c.prefetcher for c in self.cells})}"
            )
        return out

    def drift(self) -> dict:
        return drift_payload(self.spec, self.sequence, self.cells)


def drift_payload(
    spec: StreamSpec, seq: SnapshotSequence, cells: Sequence[EpochCell]
) -> dict:
    """The ``stream-drift`` JSON document: per-epoch metric curves per
    prefetcher against the stream's overlap/churn trajectory."""
    by_pf: Dict[str, List[EpochCell]] = {}
    for c in cells:
        by_pf.setdefault(c.prefetcher, []).append(c)
    prefetchers = {}
    for name, pf_cells in by_pf.items():
        pf_cells = sorted(pf_cells, key=lambda c: c.epoch)
        ms = [c.metrics for c in pf_cells]
        prefetchers[name] = {
            "lifecycle": pf_cells[0].lifecycle,
            "summary": summarize_epochs(ms),
            "per_epoch": [
                {
                    "epoch": c.epoch,
                    "speedup": c.metrics.speedup,
                    "coverage": c.metrics.coverage,
                    "accuracy": c.metrics.accuracy,
                    "useful": c.metrics.useful,
                    "issued": c.metrics.issued,
                    "baseline_l2_misses": c.metrics.baseline_l2_misses,
                    "table": c.metrics.info.get("table"),
                }
                for c in pf_cells
            ],
        }
    return {
        "schema": "stream-drift",
        "kernel": spec.kernel,
        "dataset": spec.dataset,
        "epochs": spec.epochs,
        "seed": spec.seed,
        "lifecycle": spec.lifecycle,
        "churn": {
            "kind": type(spec.churn).kind,
            **dataclasses.asdict(spec.churn),
        },
        "overlap": {
            "vertex_overlap": [s.vertex_overlap for s in seq.stats],
            "cumulative_overlap": [s.cumulative_overlap for s in seq.stats],
            "edge_churn": [s.edge_churn for s in seq.stats],
            "num_edges": [s.num_edges for s in seq.stats],
            "active_vertices": [s.active_vertices for s in seq.stats],
        },
        "prefetchers": prefetchers,
    }


__all__ = [
    "EpochCell",
    "StreamEpochSpec",
    "StreamResult",
    "StreamSpec",
    "drift_payload",
    "run_stream",
    "score_stream",
]
