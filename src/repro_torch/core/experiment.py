"""Declarative experiment API: one call evaluates a (kernel x dataset x
prefetcher) grid (PyTorch port of ``repro.core.experiment``).

Declare *what* to evaluate —

    result = Experiment(
        kernels=["cc", "bellmanford"],
        datasets=["comdblp"],
        prefetchers=["amc", "rnr"],
    ).run()
    result.metrics(kernel="cc", dataset="comdblp", prefetcher="amc").speedup

— and ``Experiment`` owns the *how*: workload construction through
:class:`~repro_torch.core.driver.WorkloadSpec` on the device the caller
names (``device=``, default the CUDA card), a :class:`WorkloadCache` so
each trace is built once and scored by every prefetcher (optionally backed
by the on-disk :class:`~repro_torch.core.exec.artifacts.ArtifactCache`),
registry resolution of prefetcher names, and composite (next-line + X)
scoring of every grid cell.  :class:`ExperimentResult` returns the tidy
per-cell rows, which equal the JAX package's row for row.

Scoring one stream is :func:`score_prefetcher`: the prefetcher's stream is
merged into the demand L2 substream, L2 and LLC are re-simulated on the
workload's device, and :func:`~repro_torch.memsim.metrics.evaluate` scores
issuer X against the baseline run.

``run(workers=N)`` shards the grid's cells across a spawned process pool
(:mod:`repro_torch.core.exec.scheduler`), each worker on the same device;
``run()`` asks the scheduler's cost model whether a pool pays.  A
:class:`~repro_torch.core.exec.sharded.ShardedSpec` workload is scored
from its on-disk shard store with bounded memory.  A
:class:`~repro_torch.stream.protocol.StreamSpec` (an evolving graph over E
versions, AMC's tables carried across them) and a
:class:`~repro_torch.serve.protocol.ServeSpec` (K tenants on one shared
LLC) expand into per-epoch / per-tenant traces, built like any workload
(across the pool under ``workers=N``) and scored in this process.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from collections.abc import Mapping, Sequence as _SequenceABC
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.driver import WorkloadSpec, WorkloadTrace, make_session
from repro_torch.core.exec.artifacts import ArtifactCache
from repro_torch.core.exec.timers import record, stage
from repro_torch.core.obs import spans as obs
from repro_torch.core.registry import Prefetcher, resolve_prefetchers
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.memsim import (
    SCALED,
    HierarchyConfig,
    PrefetchMetrics,
    current_engine,
    evaluate,
    simulate_with_prefetch,
    simulate_with_prefetch_batch,
)

def _composite_stream(workload: WorkloadTrace, stream):
    """Next-line (issuer 0) + the evaluated prefetcher (issuer 1)."""
    blocks = np.concatenate([workload.nl_blocks, stream.blocks])
    pos = np.concatenate([workload.nl_pos, stream.pos])
    issuer = np.concatenate(
        [
            np.zeros(len(workload.nl_blocks), np.int8),
            np.ones(len(stream.blocks), np.int8),
        ]
    )
    return blocks, pos, issuer


def _metrics(workload: WorkloadTrace, name: str, outcome, info) -> PrefetchMetrics:
    m = evaluate(
        name,
        workload.profile,
        outcome,
        baseline_outcome=workload.nl_outcome,
        eval_from_pos=workload.eval_from_pos,
        issuer=1,
    )
    m.info = info  # attach prefetcher-side stats
    return m


def score_prefetcher(
    workload: WorkloadTrace, name: str, generate: Prefetcher
) -> PrefetchMetrics:
    """Score one prefetcher in the composite (next-line + X) configuration."""
    with obs.span(
        "score_cell",
        prefetcher=name,
        kernel=workload.spec.kernel,
        dataset=workload.spec.dataset,
    ), stage("score"):
        stream = generate(workload)
        blocks, pos, issuer = _composite_stream(workload, stream)
        outcome = simulate_with_prefetch(
            workload.profile,
            blocks,
            pos,
            pf_issuer=issuer,
            metadata_bytes=stream.metadata_bytes,
        )
        return _metrics(workload, name, outcome, stream.info)


def score_prefetchers_batched(
    workload: WorkloadTrace, pairs: Sequence[Tuple[str, Prefetcher]]
) -> List[PrefetchMetrics]:
    """Score a family of prefetchers against one workload in one dispatch.

    Under the ``fused`` engine every prefetcher's merged L2 stream joins one
    K1 launch per level (:func:`simulate_with_prefetch_batch`); other
    engines, and single-member families, loop :func:`score_prefetcher`.
    Metrics are bit-identical either way.
    """
    if len(pairs) <= 1 or current_engine() != "fused":
        return [score_prefetcher(workload, n, g) for n, g in pairs]
    with obs.span(
        "score_batch",
        prefetchers=",".join(n for n, _ in pairs),
        kernel=workload.spec.kernel,
        dataset=workload.spec.dataset,
    ), stage("score"):
        streams = []
        for name, gen in pairs:
            # Per-cell child span over the prefetcher's own compute (its
            # stream); the joint simulation stays on the batch span.
            with obs.span(
                "score_cell",
                prefetcher=name,
                kernel=workload.spec.kernel,
                dataset=workload.spec.dataset,
                batched=True,
            ):
                streams.append(gen(workload))
        outcomes = simulate_with_prefetch_batch(
            workload.profile,
            [_composite_stream(workload, s) for s in streams],
            [s.metadata_bytes for s in streams],
        )
        return [
            _metrics(workload, name, outcome, s.info)
            for (name, _), outcome, s in zip(pairs, outcomes, streams)
        ]


def _retarget_trace(trace: WorkloadTrace, spec) -> WorkloadTrace:
    """A content-identical trace re-bound to ``spec``: the arrays are
    shared, the spec and its AMC session fresh, exactly as
    :func:`repro_torch.core.exec.artifacts._unpack` rebinds a loaded
    artifact — so scoring a reused trace equals scoring a re-emission."""
    return dataclasses.replace(
        trace, spec=spec, session=make_session(spec, trace.cfg_trace)
    )


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class WorkloadCache:
    """Build-once cache of :class:`WorkloadTrace` keyed by ``WorkloadSpec``.

    Each workload in an :class:`Experiment` is built once and scored by
    every prefetcher; pass the same cache instance to several experiments
    to reuse builds across them too (on one device: a trace asked for on
    another device than it was built on raises).

    ``artifacts`` optionally backs the in-memory store with the on-disk
    :class:`~repro_torch.core.exec.artifacts.ArtifactCache`: misses consult
    the artifact store before building, and fresh builds are persisted
    there.  Content-keyed specs (those exposing ``content_key()``) also
    deduplicate within the in-memory store: distinct specs whose traces
    are determined by identical content share one build, retargeted per
    spec (``reuses`` counts these alias hits).
    """

    def __init__(self, artifacts: Optional[ArtifactCache] = None):
        self._store: Dict[WorkloadSpec, WorkloadTrace] = {}
        self._by_content: Dict[str, WorkloadTrace] = {}
        self.artifacts = artifacts
        self.builds = 0
        self.hits = 0
        self.loads = 0  # artifact-cache (disk) hits
        self.reuses = 0  # in-memory content-alias hits (distinct specs)

    def get_or_build(self, spec: WorkloadSpec, device: DeviceLike = None) -> WorkloadTrace:
        """The trace of ``spec`` with its profile on ``device`` (default
        the CUDA card): from memory, else the artifact store, else built."""
        dev = resolve_device(device)
        if spec in self._store:
            trace = self._store[spec]
            if not _same_device(trace.device, dev):
                raise ValueError(
                    f"{spec.kernel}/{spec.dataset}#s{spec.seed} is cached on "
                    f"{trace.device}, asked for on {dev}: use a cache per device"
                )
            self.hits += 1
            obs.inc("workload_cache.hits")
            return trace
        content = getattr(spec, "content_key", None)
        ck = (
            json.dumps(content(), sort_keys=True) if callable(content) else None
        )
        with obs.span(
            "get_or_build", kernel=spec.kernel, dataset=spec.dataset
        ) as sp:
            trace = (
                self.artifacts.load(spec, device=dev)
                if self.artifacts is not None
                else None
            )
            if trace is not None:
                self.loads += 1
                obs.inc("workload_cache.loads")
                if sp:
                    sp.attrs["cache"] = "load"
            elif ck is not None and ck in self._by_content:
                trace = _retarget_trace(self._by_content[ck], spec)
                self.reuses += 1
                obs.inc("workload_cache.reuses")
                if sp:
                    sp.attrs["cache"] = "reuse"
            if trace is None:
                self.builds += 1
                obs.inc("workload_cache.builds")
                if sp:
                    sp.attrs["cache"] = "build"
                t0 = time.perf_counter()
                trace = spec.build(device=dev)
                if self.artifacts is not None:
                    self.artifacts.save(spec, trace)
                    self.artifacts.record_cost(
                        spec, build_s=time.perf_counter() - t0
                    )
            if ck is not None:
                self._by_content.setdefault(ck, trace)
            self._store[spec] = trace
            return trace

    def evict(self, spec: WorkloadSpec) -> None:
        """Drop the in-memory entry (the artifact, if any, stays on disk),
        so long sweeps can bound peak memory at one trace."""
        self._store.pop(spec, None)

    def __len__(self) -> int:
        return len(self._store)


class _LazyWorkloads(Mapping):
    """``ExperimentResult.workloads`` view that materializes traces on
    first access (artifact-cache load, else rebuild).

    After a parallel run the built traces live in the artifact store, not
    in the parent process; loading all of them eagerly would charge every
    grid run for workloads the caller never reads.  Keys are present up
    front (iteration, ``len``, membership are free); values materialize
    through the experiment's workload cache on demand — including via
    ``dict(...)``/``.items()``, which go through ``__getitem__``.
    """

    def __init__(self, loader, specs):
        self._specs = list(specs)
        self._keys = set(self._specs)
        self._loader = loader

    def __getitem__(self, spec):
        if spec not in self._keys:
            raise KeyError(spec)
        return self._loader(spec)

    def __contains__(self, spec):  # the Mapping mixin would materialize
        return spec in self._keys

    def __iter__(self):
        return iter(self._specs)

    def __len__(self):
        return len(self._specs)


class _PipelinedTraces(_SequenceABC):
    """Sequence view over a stream's epoch traces that blocks on each
    epoch's *background build* on first access, then loads it through the
    workload cache on ``device`` — the handoff between the spawn pool and
    the in-parent lifecycle scorer.  Indexing epoch 0 does not wait for
    epochs 1..E, so scoring overlaps the remaining builds."""

    def __init__(self, pipeline, specs, cache: "WorkloadCache", device):
        self._pipeline = pipeline
        self._specs = list(specs)
        self._cache = cache
        self._device = device

    def __len__(self) -> int:
        return len(self._specs)

    def __getitem__(self, i: int) -> WorkloadTrace:
        spec = self._specs[i]  # IndexError here ends Sequence iteration
        self._pipeline.wait(spec)
        return self._cache.get_or_build(spec, device=self._device)


@dataclasses.dataclass(frozen=True)
class CellResult:
    """One grid cell: a prefetcher scored on one workload.

    Stream cells (from a :class:`repro_torch.stream.protocol.StreamSpec`
    workload) additionally carry the epoch index and, for lifecycle-aware
    prefetchers, the table-lifecycle policy; serving cells (from a
    :class:`repro_torch.serve.protocol.ServeSpec`) carry the tenant index
    and, for AMC-family prefetchers, the table mode.  All stay ``None`` for
    plain workload cells, whose row schema is unchanged.
    """

    kernel: str
    dataset: str
    prefetcher: str
    seed: int
    metrics: PrefetchMetrics
    spec: Optional[WorkloadSpec] = None  # full workload identity
    epoch: Optional[int] = None  # stream cells only
    lifecycle: Optional[str] = None  # stream cells with carried tables
    tenant: Optional[int] = None  # serving cells only
    table_mode: Optional[str] = None  # serving cells, AMC family


@dataclasses.dataclass
class ExperimentResult:
    """Structured result over the full evaluation grid.

    ``workloads`` is keyed by the full :class:`WorkloadSpec` (specs
    differing only in hierarchy or element sizes stay distinct); filter
    cells by ``spec=`` when kernel/dataset/seed alone are ambiguous.
    After a parallel run it is a lazy mapping that loads each trace from
    the artifact store on first access.  Sharded specs have no whole trace
    and are never in it.
    """

    cells: List[CellResult]
    workloads: Mapping
    # The scheduler's decision (``SchedDecision.as_dict()``) when
    # ``run(workers=None)`` consulted its cost model; None when the caller
    # fixed ``workers``.
    sched: Optional[dict] = None
    # Epoch traces served from the content-addressed cache instead of
    # being re-emitted (delta-aware reuse; counts stream epochs only).
    trace_reuse: int = 0
    # Run telemetry: the run manifest (git sha, engine, emitter, schema
    # versions, torch version, device name), workload-cache counters, and
    # — when a tracer was active — the trace id.
    telemetry: Optional[dict] = None

    def select(self, **filters) -> List[CellResult]:
        """Cells matching all given kernel/dataset/prefetcher/seed filters."""
        out = self.cells
        for field, want in filters.items():
            out = [c for c in out if getattr(c, field) == want]
        return out

    def metrics(self, **filters) -> PrefetchMetrics:
        """The unique cell's metrics matching the filters (error otherwise)."""
        hits = self.select(**filters)
        if len(hits) != 1:
            raise KeyError(
                f"filters {filters} matched {len(hits)} cells, expected 1"
            )
        return hits[0].metrics

    def suite(self, kernel: str, dataset: str, seed: int = 0) -> Dict[str, PrefetchMetrics]:
        """``{prefetcher: metrics}`` view of one workload cell."""
        cells = self.select(kernel=kernel, dataset=dataset, seed=seed)
        if not cells:
            raise KeyError(
                f"({kernel}, {dataset}, seed={seed}) matched no cells; "
                f"workloads run: {sorted(set((c.kernel, c.dataset, c.seed) for c in self.cells))}"
            )
        out: Dict[str, PrefetchMetrics] = {}
        for c in cells:
            if c.prefetcher in out:
                raise KeyError(
                    f"({kernel}, {dataset}, seed={seed}) matched multiple "
                    "workload specs; use select(spec=...) to disambiguate"
                )
            out[c.prefetcher] = c.metrics
        return out

    def rows(self) -> List[dict]:
        """Tidy per-cell rows: grid coordinates + flattened metrics, the
        JAX package's schema.

        Stream cells gain ``epoch`` (and ``lifecycle``) columns; serving
        cells gain ``tenant`` (and ``table_mode``); plain cells keep the
        plain schema.
        """
        out = []
        for c in self.cells:
            row = dict(
                kernel=c.kernel,
                dataset=c.dataset,
                prefetcher=c.prefetcher,
                seed=c.seed,
            )
            if c.epoch is not None:
                row["epoch"] = c.epoch
                row["lifecycle"] = c.lifecycle
            if c.tenant is not None:
                row["tenant"] = c.tenant
                row["table_mode"] = c.table_mode
            row.update(c.metrics.row())
            out.append(row)
        return out

    def workload(self, kernel: str, dataset: str, seed: int = 0) -> WorkloadTrace:
        """The unique built trace for (kernel, dataset, seed); with several
        specs sharing those coordinates, index ``workloads`` by spec."""
        hits = [
            s
            for s in self.workloads
            if (s.kernel, s.dataset, s.seed) == (kernel, dataset, seed)
        ]
        if len(hits) != 1:
            raise KeyError(
                f"({kernel}, {dataset}, seed={seed}) matched {len(hits)} "
                "workloads; index result.workloads by WorkloadSpec instead"
            )
        return self.workloads[hits[0]]


class Experiment:
    """Declarative prefetcher-evaluation grid.

    Either give ``kernels`` + ``datasets`` (the cross product is taken, once
    per seed) or pass explicit ``workloads=[WorkloadSpec(...), ...]``.
    ``prefetchers`` accepts registry names, :class:`PrefetcherSpec` objects,
    ``(name, generator)`` pairs, or a mapping — see
    :func:`repro_torch.core.registry.resolve_prefetchers`.  Every workload
    is built, and scored, on ``device`` (default the CUDA card; a run with
    no card raises), in this process or in the scheduler's workers.
    ``workloads`` may mix plain specs,
    :class:`~repro_torch.core.exec.sharded.ShardedSpec`,
    :class:`~repro_torch.stream.protocol.StreamSpec` and
    :class:`~repro_torch.serve.protocol.ServeSpec` ones.
    """

    def __init__(
        self,
        kernels: Optional[Sequence[str]] = None,
        datasets: Optional[Sequence[str]] = None,
        prefetchers: Iterable = ("amc",),
        hierarchy: HierarchyConfig = SCALED,
        seeds: Sequence[int] = (0,),
        workloads: Optional[Sequence[WorkloadSpec]] = None,
        cache: Optional[WorkloadCache] = None,
        device: DeviceLike = None,
    ):
        if workloads is not None:
            if kernels is not None or datasets is not None:
                raise ValueError("pass either workloads= or kernels=+datasets=")
            if hierarchy is not SCALED or tuple(seeds) != (0,):
                raise ValueError(
                    "hierarchy=/seeds= apply to the kernels=+datasets= grid; "
                    "with workloads=, declare them on each WorkloadSpec"
                )
            # Multi-epoch stream scenarios (repro_torch.stream.protocol.
            # StreamSpec) and multi-tenant serving scenarios (repro_torch.
            # serve.protocol.ServeSpec) mix freely with plain workloads;
            # they expand into per-epoch / per-tenant workload specs at run
            # time and score through their protocol modules (duck-typed so
            # those modules load lazily).
            self.stream_specs = [
                w for w in workloads if getattr(w, "is_stream", False)
            ]
            self.serve_specs = [
                w for w in workloads if getattr(w, "is_serve", False)
            ]
            self.workload_specs = [
                w
                for w in workloads
                if not getattr(w, "is_stream", False)
                and not getattr(w, "is_serve", False)
            ]
        else:
            self.stream_specs = []
            self.serve_specs = []
            if not kernels or not datasets:
                raise ValueError("kernels= and datasets= must both be non-empty")
            self.workload_specs = [
                WorkloadSpec(kernel=k, dataset=d, hierarchy=hierarchy, seed=s)
                for k in kernels
                for d in datasets
                for s in seeds
            ]
        # Fail fast on typo'd names at declaration time, not first build.
        for spec in self.workload_specs + self.stream_specs + self.serve_specs:
            spec.validate_names()
        self.prefetchers: List[Tuple[str, Prefetcher]] = resolve_prefetchers(
            prefetchers
        )
        self.cache = cache if cache is not None else WorkloadCache()
        self.device = resolve_device(device)

    @property
    def prefetcher_names(self) -> List[str]:
        return [name for name, _ in self.prefetchers]

    @property
    def grid(self) -> List[Tuple[WorkloadSpec, str]]:
        """The full (workload, prefetcher) evaluation grid, in run order."""
        return [
            (spec, name)
            for spec in self.workload_specs
            for name in self.prefetcher_names
        ]

    def run(
        self,
        verbose: bool = False,
        workers: Optional[int] = None,
        pipeline: bool = True,
    ) -> ExperimentResult:
        """Build every workload (cached) and score every grid cell.

        ``workers=N`` (N >= 2) opts into the parallel execution engine:
        cells are sharded across a spawned process pool, grouped by
        workload so each trace is built once, with built traces persisted
        in the workload artifact cache; every worker runs on ``device``.
        ``workers=1`` forces the serial path, in this process.  The default
        (``workers=None``) consults the scheduler's cost model
        (:func:`repro_torch.core.exec.scheduler.plan_execution`): a pool is
        spawned only when its predicted time — spawn overhead plus the
        load-balanced makespan — beats running in-process.  On one core,
        under host or card memory pressure, or with unpicklable ad-hoc
        prefetchers (which cannot cross the spawn boundary) the run stays
        serial.  The decision is surfaced as ``result.sched``.

        ``pipeline`` selects the overlapped schedule (score tasks
        dispatched as their builds complete) over the phased
        materialize-all-then-score-all schedule; both are bit-identical to
        serial.  Cell order and every metric equal the JAX package's.

        Stream workloads expand into per-epoch traces (built/cached like
        any workload — under ``workers=N`` the epochs of every stream are
        materialized across the pool and handed to the scorer as each
        build lands) and are scored *in this process* by the stream
        protocol, whose cross-epoch table lifecycle is inherently
        sequential; stream results are therefore byte-identical between
        serial and parallel runs too.  Serving workloads follow the same
        contract: per-tenant traces materialize across the pool, the
        interleaved shared-LLC scoring runs here.  Epoch traces are
        content-keyed, so epochs whose graph the churn model left unchanged
        are *reused* rather than re-emitted (``result.trace_reuse`` counts
        them).
        """
        with obs.span(
            "experiment_run",
            workloads=len(self.workload_specs),
            streams=len(self.stream_specs),
            serves=len(self.serve_specs),
            prefetchers=self.prefetcher_names,
        ):
            result = self._run_impl(verbose, workers, pipeline)
        result.telemetry = self._telemetry(result.sched)
        return result

    def _cell(self, spec, name: str, m: PrefetchMetrics, verbose: bool) -> CellResult:
        if verbose:
            print(
                f"[{spec.kernel}/{spec.dataset}] {name}: "
                f"speedup {m.speedup:.2f} coverage {m.coverage:.2f} "
                f"accuracy {m.accuracy:.2f}"
            )
        return CellResult(
            kernel=spec.kernel,
            dataset=spec.dataset,
            prefetcher=name,
            seed=spec.seed,
            metrics=m,
            spec=spec,
        )

    def _run_impl(
        self, verbose: bool, workers: Optional[int], pipeline: bool
    ) -> ExperimentResult:
        sched = None
        if workers is None:
            sched = self._plan_schedule()
            record(f"sched_decision[{sched.mode}]")
            workers = sched.workers
        if workers > 1:
            if self.workload_specs:
                result = self._run_parallel(workers, verbose, pipeline)
            else:  # stream/serve-only grid: no cells to shard, only builds
                result = ExperimentResult(cells=[], workloads={})
            if self.stream_specs:
                self._append_stream_cells(result, verbose, workers=workers)
            if self.serve_specs:
                self._append_serve_cells(result, verbose, workers=workers)
            result.sched = sched.as_dict() if sched is not None else None
            return result
        cells: List[CellResult] = []
        traces: Dict[WorkloadSpec, WorkloadTrace] = {}
        for spec in self.workload_specs:
            if getattr(spec, "is_sharded", False):
                # Sharded cells stream from the on-disk shard store (never a
                # whole WorkloadTrace), so they always need an artifact cache
                # — attach the default one exactly as the parallel path does.
                from repro_torch.core.exec import sharded

                if self.cache.artifacts is None:
                    self.cache.artifacts = ArtifactCache()
                for name, m in sharded.score_sharded(
                    spec, self.prefetchers, self.cache.artifacts, device=self.device
                ):
                    cells.append(self._cell(spec, name, m, verbose))
                continue
            w = self.cache.get_or_build(spec, device=self.device)
            traces[spec] = w
            t0 = time.perf_counter()
            metrics = score_prefetchers_batched(w, self.prefetchers)
            if self.cache.artifacts is not None and self.prefetchers:
                self.cache.artifacts.record_cost(
                    spec,
                    score_s_per_prefetcher=(
                        (time.perf_counter() - t0) / len(self.prefetchers)
                    ),
                )
            for name, m in zip(self.prefetcher_names, metrics):
                cells.append(self._cell(spec, name, m, verbose))
        result = ExperimentResult(cells=cells, workloads=traces)
        if self.stream_specs:
            self._append_stream_cells(result, verbose, workers=None)
        if self.serve_specs:
            self._append_serve_cells(result, verbose, workers=None)
        result.sched = sched.as_dict() if sched is not None else None
        return result

    def _plan_schedule(self):
        """Resolve ``workers=None`` through the scheduler's cost model.

        Every independent build in the run — plain workloads, stream
        epochs, serve tenants — is costed against the artifact store;
        :func:`repro_torch.core.exec.scheduler.plan_execution` then picks
        serial in-process execution or a pipelined pool sized from the
        predicted makespan, the host's cores and memory and, on a card,
        its free memory.  Unpicklable ad-hoc prefetchers force serial
        (``workers=N`` rejects them loudly, but a *default* must tolerate
        them)."""
        from repro_torch.core.exec import scheduler  # lazy: avoids import cycle

        try:
            for _, gen in self.prefetchers:
                pickle.dumps(gen)
        except Exception:
            return scheduler.SchedDecision(
                mode="serial",
                workers=1,
                est_serial_s=0.0,
                est_pool_s=None,
                reason=(
                    "unpicklable ad-hoc prefetchers cannot cross the "
                    "spawn boundary"
                ),
                cores=os.cpu_count() or 1,
                n_tasks=0,
                measured_frac=0.0,
            )
        specs = list(self.workload_specs)
        for s in self.stream_specs:
            specs.extend(s.epoch_specs())
        for s in self.serve_specs:
            specs.extend(s.tenant_workloads())
        artifacts = (
            self.cache.artifacts
            if self.cache.artifacts is not None
            else ArtifactCache()
        )
        return scheduler.plan_execution(
            specs, len(self.prefetchers), artifacts, device=self.device
        )

    def _append_stream_cells(
        self, result: ExperimentResult, verbose: bool, workers: Optional[int]
    ) -> None:
        """Score every stream scenario and fold its per-epoch cells in.

        Parallel runs hand epochs off as they materialize: the lifecycle
        scorer starts on epoch 0 while later epochs are still building in
        the pool (:class:`~repro_torch.core.exec.scheduler.MaterializePipeline`
        + :class:`_PipelinedTraces`), instead of waiting for all builds.
        Either path counts delta-aware reuse — unique epoch specs whose
        trace came from the content-addressed cache (or an in-memory
        content alias) rather than a fresh emission — into
        ``result.trace_reuse``; the count is identical serial vs pooled.
        """
        from repro_torch.stream import protocol  # lazy: the protocol imports us

        dev = self.device
        epoch_specs = {
            es: None for spec in self.stream_specs for es in spec.epoch_specs()
        }
        builds_before = self.cache.builds
        pipeline = None
        if workers is not None and workers > 1:
            # Epochs are independent *builds*: fan them across the pool,
            # then walk the lifecycle sequentially here, pulling each epoch
            # as its build lands.
            from repro_torch.core.exec import scheduler

            if self.cache.artifacts is None:
                self.cache.artifacts = ArtifactCache()
            pipeline = scheduler.MaterializePipeline(
                list(epoch_specs),
                workers=workers,
                artifacts=self.cache.artifacts,
                device=dev,
            )
        try:
            for spec in self.stream_specs:
                if pipeline is not None:
                    traces: Sequence = _PipelinedTraces(
                        pipeline, spec.epoch_specs(), self.cache, dev
                    )
                else:
                    traces = [
                        self.cache.get_or_build(es, device=dev)
                        for es in spec.epoch_specs()
                    ]
                for cell in protocol.score_stream(spec, self.prefetchers, traces):
                    result.cells.append(
                        CellResult(
                            kernel=spec.kernel,
                            dataset=spec.dataset,
                            prefetcher=cell.prefetcher,
                            seed=spec.seed,
                            metrics=cell.metrics,
                            spec=cell.spec,
                            epoch=cell.epoch,
                            lifecycle=cell.lifecycle,
                        )
                    )
                    if verbose:
                        m = cell.metrics
                        print(
                            f"[{spec.kernel}/{spec.dataset}@e{cell.epoch}] "
                            f"{cell.prefetcher}: speedup {m.speedup:.2f} "
                            f"coverage {m.coverage:.2f} accuracy {m.accuracy:.2f}"
                        )
        finally:
            if pipeline is not None:
                pipeline.close()
        if pipeline is not None:
            result.trace_reuse += pipeline.n_specs - pipeline.n_built
        else:
            result.trace_reuse += len(epoch_specs) - (
                self.cache.builds - builds_before
            )
        load = lambda s: self.cache.get_or_build(s, device=dev)  # noqa: E731
        if isinstance(result.workloads, dict):
            for spec in self.stream_specs:
                for es in spec.epoch_specs():
                    result.workloads[es] = load(es)
        else:
            result.workloads = _LazyWorkloads(
                load, list(result.workloads) + list(epoch_specs)
            )

    def _append_serve_cells(
        self, result: ExperimentResult, verbose: bool, workers: Optional[int]
    ) -> None:
        """Score every serving scenario and fold its per-tenant cells in."""
        from repro_torch.serve import protocol  # lazy: the protocol imports us

        dev = self.device
        tenant_specs = {
            ws: None
            for spec in self.serve_specs
            for ws in spec.tenant_workloads()
        }
        if workers is not None and workers > 1:
            # Tenants are independent *builds*: materialize them across
            # the pool, then run the interleaved scoring here.
            from repro_torch.core.exec import scheduler

            if self.cache.artifacts is None:
                self.cache.artifacts = ArtifactCache()
            scheduler.materialize_specs(
                list(tenant_specs),
                workers=workers,
                artifacts=self.cache.artifacts,
                device=dev,
            )
        for spec in self.serve_specs:
            traces = [
                self.cache.get_or_build(ws, device=dev)
                for ws in spec.tenant_workloads()
            ]
            for cell in protocol.score_serve(spec, self.prefetchers, traces):
                ws = cell.spec
                result.cells.append(
                    CellResult(
                        kernel=ws.kernel,
                        dataset=ws.dataset,
                        prefetcher=cell.prefetcher,
                        seed=ws.seed,
                        metrics=cell.metrics,
                        spec=ws,
                        tenant=cell.tenant,
                        table_mode=cell.table_mode,
                    )
                )
                if verbose:
                    m = cell.metrics
                    mode = cell.table_mode or "stateless"
                    print(
                        f"[{ws.kernel}/{ws.dataset}@t{cell.tenant}] "
                        f"{cell.prefetcher}/{mode}: speedup {m.speedup:.2f} "
                        f"coverage {m.coverage:.2f} accuracy {m.accuracy:.2f}"
                    )
        load = lambda s: self.cache.get_or_build(s, device=dev)  # noqa: E731
        if isinstance(result.workloads, dict):
            for ws in tenant_specs:
                result.workloads[ws] = load(ws)
        else:
            known = set(result.workloads)
            result.workloads = _LazyWorkloads(
                load,
                list(result.workloads)
                + [ws for ws in tenant_specs if ws not in known],
            )

    def _run_parallel(
        self, workers: int, verbose: bool, pipeline: bool = True
    ) -> ExperimentResult:
        from repro_torch.core.exec import scheduler  # lazy: avoids import cycle

        if self.cache.artifacts is None:
            # Workers share builds through the artifact store; attach the
            # default one so the in-process cache sees the same artifacts.
            self.cache.artifacts = ArtifactCache()
        metrics, prebuilt = scheduler.run_grid(
            self.workload_specs,
            self.prefetchers,
            workers=workers,
            artifacts=self.cache.artifacts,
            verbose=verbose,
            pipeline=pipeline,
            device=self.device,
        )
        # Later experiments sharing this cache reuse any parent-side builds.
        for spec, trace in prebuilt.items():
            self.cache._store.setdefault(spec, trace)
        cells = [
            CellResult(
                kernel=spec.kernel,
                dataset=spec.dataset,
                prefetcher=name,
                seed=spec.seed,
                metrics=metrics[(spec, name)],
                spec=spec,
            )
            for spec in self.workload_specs
            for name in self.prefetcher_names
        ]
        # Workers persisted their traces in the artifact store; materialize
        # them lazily so runs that only read metrics never pay the loads.
        # Sharded cells have no whole-trace artifact to load, so they are
        # never part of the workloads mapping (serial runs agree).
        workloads = _LazyWorkloads(
            lambda spec: self.cache.get_or_build(spec, device=self.device),
            dict.fromkeys(
                s
                for s in self.workload_specs
                if not getattr(s, "is_sharded", False)
            ),
        )
        return ExperimentResult(cells=cells, workloads=workloads)

    def _telemetry(self, sched: Optional[dict]) -> dict:
        """Provenance + counters block for ``ExperimentResult.telemetry``."""
        from repro_torch.core.obs.manifest import run_manifest

        doc = {
            "manifest": run_manifest(sched=sched, device=self.device),
            "workload_cache": {
                "hits": self.cache.hits,
                "builds": self.cache.builds,
                "loads": self.cache.loads,
                "reuses": self.cache.reuses,
            },
        }
        tracer = obs.current_tracer()
        if tracer is not None:
            doc["trace_id"] = tracer.trace_id
        return doc


__all__ = [
    "CellResult",
    "Experiment",
    "ExperimentResult",
    "WorkloadCache",
    "score_prefetcher",
    "score_prefetchers_batched",
]
