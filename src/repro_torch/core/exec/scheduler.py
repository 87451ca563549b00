"""Parallel grid scheduler: shard (workload x prefetcher) cells across a
process pool (PyTorch port of ``repro.core.exec.scheduler``).

The unit of work is one *task* = (WorkloadSpec, [prefetcher subset]).  Each
worker materializes its task's trace once — an artifact-cache load when
present, else a full build persisted for every later task and run — and
scores the task's prefetchers sequentially against it.  An unmaterialized
workload is always a single task, so its expensive build happens exactly
once, in the worker that scores it; a workload already in the artifact
store loads in seconds, so its prefetcher list is split across sibling
tasks (targeting ~2 tasks per worker, heaviest dispatched first) so one
heavy workload cannot serialize the tail of the run.

Determinism: workers return ``(task_index, [(name, metrics), ...])`` and
the parent reassembles cells in the exact workload-major, prefetcher-minor
order the serial path uses, so parallel output is bit-identical to serial
(``tests/test_torch_scheduler.py``).

**The device crosses the spawn boundary.**  Every task carries the
caller's device, resolved in the parent (``"cuda..."`` or ``"cpu"``); a
worker resolves it again with :func:`~repro_torch.device.resolve_device`,
so a worker sent to the card that finds none raises instead of running on
the CPU.  Spawned workers share the card, each with its own CUDA context;
the pool-width cap counts the card's free memory less one context per
worker beside the host's.  Before a pool on the card starts, the parent
builds the graph path's kernels, so workers load a built library and never
race ``nvcc``.

Workers are *spawned*, not forked: a process with a live CUDA context (or
running thread pools) cannot be forked safely.  Spawned workers re-import
the package, so the parent exports the ``repro_torch`` source root on
``PYTHONPATH`` for the pool's lifetime.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import time
from concurrent.futures import (
    FIRST_COMPLETED,
    ProcessPoolExecutor,
    as_completed,
    wait,
)
from multiprocessing import get_context
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

import repro_torch
from repro_torch.core.driver import WorkloadSpec, WorkloadTrace
from repro_torch.core.exec.artifacts import ArtifactCache
from repro_torch.core.exec.timers import record
from repro_torch.core.experiment import score_prefetcher
from repro_torch.core.obs import spans as obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.memsim import PrefetchMetrics

DEBUG_ENV = "REPRO_TORCH_EXEC_DEBUG"

# Per-worker-process memo of the last materialized trace: pool processes
# run many tasks, and consecutive tasks for the same workload (a split
# prefetcher list) should not reload the artifact.  One entry bounds memory.
_LAST_TRACE: Optional[Tuple[tuple, WorkloadTrace]] = None


def _materialize(
    spec: WorkloadSpec, cache_root: str, device: DeviceLike
) -> Optional[WorkloadTrace]:
    global _LAST_TRACE
    dev = resolve_device(device)
    if getattr(spec, "is_sharded", False):
        # Sharded workloads materialize as a shard store + manifest, not a
        # WorkloadTrace; nothing stays resident in the worker.
        from repro_torch.core.exec import sharded

        sharded.ensure_shards(spec, ArtifactCache(cache_root), dev)
        return None
    key = (cache_root, spec, str(dev))
    with obs.span(
        "materialize", kernel=spec.kernel, dataset=spec.dataset
    ) as sp:
        if _LAST_TRACE is not None and _LAST_TRACE[0] == key:
            if sp:
                sp.attrs["cache"] = "memo"
            obs.inc("artifact.memo_hits")
            return _LAST_TRACE[1]
        cache = ArtifactCache(cache_root)
        if sp:
            sp.attrs["cache_key"] = cache.path_for(spec).name
        trace = cache.load(spec, device=dev)
        if trace is None:
            t0 = time.perf_counter()
            trace = spec.build(device=dev)
            cache.save(spec, trace)
            cache.record_cost(spec, build_s=time.perf_counter() - t0)
            if sp:
                sp.attrs["cache"] = "build"
            obs.inc("artifact.builds")
        else:
            if sp:
                sp.attrs["cache"] = "load"
            obs.inc("artifact.loads")
        _LAST_TRACE = (key, trace)
        return trace


def _debug(spec, what: str, t0: float) -> None:
    if os.environ.get(DEBUG_ENV):
        print(
            f"[worker {os.getpid()}] {spec.kernel}/{spec.dataset} {what} "
            f"{time.perf_counter() - t0:.1f}s",
            flush=True,
        )


def _run_task(task) -> Tuple[int, List[Tuple[str, PrefetchMetrics]]]:
    """Worker body: build-or-load one trace, score its prefetchers."""
    index, spec, prefetchers, cache_root, device = task
    dev = resolve_device(device)
    try:
        with obs.span(
            "run_task",
            task=index,
            kernel=spec.kernel,
            dataset=spec.dataset,
            prefetchers=[name for name, _ in prefetchers],
            sharded=bool(getattr(spec, "is_sharded", False)),
            device=str(dev),
        ):
            if getattr(spec, "is_sharded", False):
                # Sharded tasks stream shards through the bounded-memory
                # scorer; the shard store (cached by content key) is built
                # on first touch.
                from repro_torch.core.exec import sharded

                t0 = time.perf_counter()
                scored = sharded.score_sharded(
                    spec, list(prefetchers), ArtifactCache(cache_root), device=dev
                )
                _debug(spec, f"sharded x{len(prefetchers)}", t0)
                return index, scored
            t0 = time.perf_counter()
            trace = _materialize(spec, cache_root, dev)
            _debug(spec, "materialize", t0)
            scored = []
            score_t0 = time.perf_counter()
            for name, gen in prefetchers:
                t0 = time.perf_counter()
                scored.append((name, score_prefetcher(trace, name, gen)))
                _debug(spec, f"score {name}", t0)
            if prefetchers:
                ArtifactCache(cache_root).record_cost(
                    spec,
                    score_s_per_prefetcher=(
                        (time.perf_counter() - score_t0) / len(prefetchers)
                    ),
                )
            return index, scored
    finally:
        # Task boundary: land this process's cumulative counters so the
        # parent's merge sees worker-side cache hit/build splits.
        obs.flush_worker_metrics()


def _split(items: Sequence, n: int) -> List[list]:
    """Split into ``n`` (or fewer) contiguous near-equal chunks."""
    n = max(1, min(n, len(items)))
    size, rem = divmod(len(items), n)
    out, i = [], 0
    for j in range(n):
        step = size + (1 if j < rem else 0)
        out.append(list(items[i : i + step]))
        i += step
    return out


def _plan(
    specs: Sequence[WorkloadSpec],
    prefetchers: Sequence[tuple],
    workers: int,
    artifacts: ArtifactCache,
) -> Tuple[List[WorkloadSpec], List[tuple]]:
    """(unique specs, [(spec, prefetcher chunk), ...]) task list.

    An *unmaterialized* workload is one task — its (expensive) build must
    happen exactly once, in the worker that scores it.  A workload already
    in the artifact store loads in seconds, so its prefetcher list may be
    split across sibling tasks for load balance; we aim for ~2 tasks per
    worker so one heavy workload cannot serialize the tail of the run.
    """
    unique = list(dict.fromkeys(specs))
    target_tasks = max(2 * workers, len(unique))
    chunks_per_cached = max(1, -(-target_tasks // len(unique)))  # ceil
    tasks = []
    for spec in unique:
        n_chunks = chunks_per_cached if artifacts.has(spec) else 1
        for chunk in _split(prefetchers, n_chunks):
            tasks.append((spec, chunk))
    return unique, tasks


def _check_picklable(prefetchers: Sequence[tuple]) -> None:
    for name, gen in prefetchers:
        try:
            pickle.dumps(gen)
        except Exception as e:
            raise ValueError(
                f"prefetcher {name!r} is not picklable and cannot be shipped "
                "to worker processes — parallel execution needs module-level "
                "generators or registry factories (lambdas and closures are "
                "not); run serially or register the prefetcher"
            ) from e


# ------------------------------------------------------------ cost model
#
# The scheduler sizes its pool from *predicted* task cost instead of a
# blind min(cores, builds): where spawn + import + CUDA-context overhead
# exceeds the parallel gain, the model degrades to serial in-process
# execution and no pool is spawned at all.
#
# Costs come from metadata the artifact cache already records, preferred
# in this order: *measured* build/score seconds persisted in each
# artifact's cost sidecar by earlier runs (``ArtifactCache.record_cost``);
# a materialized trace's compressed size as a direct access-count proxy
# (``measured``); and, cold, a dataset-size estimate from the DATASETS
# registry.  The constants below are the port's own, measured by
# ``chip_smoke.py`` phase 14 on an NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit, whose host has 8 cores (the run of 2026-10-17); the JAX
# package's were fitted on a 1-CPU XLA host and do not carry over.  They
# only need order-of-magnitude fidelity: the decision margins they guard
# (spawn overhead vs multi-core speedup) are order-of-magnitude too.

# Phase 13's G cold (the BENCH v9 grid, 5,032,293 accesses): trace_gen +
# demand_sim + the artifact saves, 13.98 s, over its accesses.
BUILD_S_PER_ACCESS = 2.78e-6
# The same run: score, 5.13 s, over its accesses x 2 prefetchers.
SCORE_S_PER_ACCESS = 5.10e-7
# Phase 13's G warm: the artifact loads, 1.06 s, over its accesses.
LOAD_S_PER_ACCESS = 2.11e-7
# G cold's .npz files, 31.4 MB, over its accesses: size -> access count.
ARTIFACT_BYTES_PER_ACCESS = 6.24
# G's traces' numpy arrays, 235.4 MB, over its accesses (host).
TRACE_BYTES_PER_ACCESS = 46.8
# bfs/road-8m's peak allocation on the card, 202.4 MB, over its 4,194,304-
# access shard: the card's transient bytes per access of a pass.
DEVICE_BYTES_PER_ACCESS = 48.3
# A pool of P workers that import repro_torch, open a CUDA context and load
# the kernels: 7.17 / 8.47 / 9.21 s at P = 1 / 2 / 4, fitted as
# t(P) = base + P x per_worker.
SPAWN_BASE_S = 6.8
SPAWN_PER_WORKER_S = 0.63
# The card's free memory one worker's CUDA context takes (647.6 MB at
# P = 1, 2 and 4).
CUDA_CONTEXT_BYTES = 648_000_000
SPARSE_TRAVERSAL_DISCOUNT = 0.4  # frontier kernels touch a graph fraction


@dataclasses.dataclass(frozen=True)
class TaskCost:
    """Predicted cost of one workload spec's build + scoring."""

    spec: object
    build_s: float  # 0.0 when the artifact store already holds the trace
    score_s: float  # all prefetchers against this spec
    resident_bytes: float  # host
    measured: bool  # True when sized from a real artifact, not a guess
    device_bytes: float = 0.0  # the card's transient bytes while it scores

    @property
    def total_s(self) -> float:
        return self.build_s + self.score_s


@dataclasses.dataclass(frozen=True)
class SchedDecision:
    """The scheduler's resolved execution mode for one run.

    Surfaced as ``ExperimentResult.sched``, so every run documents *why*
    it went serial or parallel on its host.
    """

    mode: str  # "serial" | "pipeline"
    workers: int  # 1 for serial, else the chosen pool width
    est_serial_s: float
    est_pool_s: Optional[float]  # best pool estimate (None: pool impossible)
    reason: str
    cores: int
    n_tasks: int
    measured_frac: float  # fraction of estimates backed by real artifacts

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _dataset_shape(name: str) -> Tuple[int, int]:
    """(vertices, edges) from the DATASETS registry, with a generic
    fallback so unknown names still get a nonzero estimate."""
    from repro_torch.graphs.generators import DATASETS

    ds = DATASETS.get(name)
    if ds is None:
        return 50_000, 200_000
    n = int(ds.get("n", 50_000))
    m = int(ds.get("m", 4 * n))  # road graphs omit m: ~4 edges/vertex
    return n, m


def _estimate_accesses(spec) -> float:
    """Spec-derived access-count estimate for a cold (unbuilt) workload."""
    from repro_torch.apps.registry import kernel_traits

    n, m = _dataset_shape(spec.dataset)
    traits = kernel_traits(spec.kernel)
    per_pass = n + 3.0 * m  # vertex props + offsets/neighbors/frontier
    if traits.two_run:
        # Traversals: two runs, each visiting a sparse-frontier fraction.
        accesses = 2.0 * per_pass * SPARSE_TRAVERSAL_DISCOUNT
    else:
        accesses = 12.0 * per_pass  # iterative kernels: ~a dozen sweeps
    if getattr(spec, "epochs", None) is not None and hasattr(spec, "epoch"):
        # A stream epoch is a single run in the shared address layout.
        accesses /= 2.0 if traits.two_run else 12.0
    return accesses


def estimate_cost(spec, n_prefetchers: int, artifacts: ArtifactCache) -> TaskCost:
    """Predict build/score cost for one spec from cache metadata.

    Measured per-task seconds from the artifact's cost sidecar
    (:meth:`~repro_torch.core.exec.artifacts.ArtifactCache.record_cost`)
    beat every constant: a recorded ``score_s_per_prefetcher`` prices
    scoring exactly, and a recorded ``build_s`` prices a rebuild of a spec
    whose artifact is gone but whose sidecar survived.  Otherwise
    materialized specs are sized from their artifact's compressed size
    (sharded specs from the manifest's exact access count) and pay only a
    load, not a build; cold specs fall back to the DATASETS-derived
    estimate.  Deterministic given the artifact store's state.
    """
    accesses: Optional[float] = None
    measured = False
    if getattr(spec, "is_sharded", False):
        manifest = artifacts.load_manifest(spec)
        if manifest is not None:
            accesses, measured = float(manifest["num_accesses"]), True
    else:
        try:
            size = artifacts.path_for(spec).stat().st_size
            accesses, measured = size / ARTIFACT_BYTES_PER_ACCESS, True
        except OSError:
            pass
    if accesses is None:
        accesses = _estimate_accesses(spec)
    recorded = artifacts.load_cost(spec) or {}
    if measured:
        build_s = accesses * LOAD_S_PER_ACCESS
    elif "build_s" in recorded:
        build_s, measured = float(recorded["build_s"]), True
    else:
        build_s = accesses * BUILD_S_PER_ACCESS
    if "score_s_per_prefetcher" in recorded:
        score_s = float(recorded["score_s_per_prefetcher"]) * n_prefetchers
    else:
        score_s = accesses * SCORE_S_PER_ACCESS * n_prefetchers
    return TaskCost(
        spec=spec,
        build_s=build_s,
        score_s=score_s,
        resident_bytes=accesses * TRACE_BYTES_PER_ACCESS,
        measured=measured,
        device_bytes=accesses * DEVICE_BYTES_PER_ACCESS,
    )


def _lpt_makespan(costs_s: Sequence[float], bins: int) -> float:
    """Longest-processing-time-first makespan of ``costs_s`` over ``bins``
    equal workers — the same greedy order the dispatcher uses."""
    loads = [0.0] * max(1, bins)
    for c in sorted(costs_s, reverse=True):
        loads[loads.index(min(loads))] += c
    return max(loads)


def decide(
    costs: Sequence[TaskCost],
    *,
    cores: int,
    mem_bytes: Optional[int] = None,
    device_mem_bytes: Optional[int] = None,
) -> SchedDecision:
    """Pure decision function: serial vs pipelined pool, and pool width.

    Deterministic for fixed inputs (tested).  Serial wins whenever the
    best pool estimate — spawn overhead plus the LPT makespan across P
    workers — is no better than just running the work in-process, which
    is always the case on a single core, and whenever available memory
    cannot hold two workers at once: ``mem_bytes`` of the host against
    each worker's resident trace, and (on a card) ``device_mem_bytes``
    of the card's free memory against each worker's CUDA context plus its
    passes' transient bytes.
    """
    serial_s = sum(c.total_s for c in costs)
    n = len(costs)
    base = dict(
        est_serial_s=serial_s,
        cores=cores,
        n_tasks=n,
        measured_frac=(sum(c.measured for c in costs) / n) if n else 1.0,
    )
    if n <= 1:
        return SchedDecision(
            mode="serial", workers=1, est_pool_s=None,
            reason="at most one independent task — nothing to overlap",
            **base,
        )
    if cores <= 1:
        return SchedDecision(
            mode="serial", workers=1, est_pool_s=None,
            reason="single core — a pool only adds spawn and contention cost",
            **base,
        )
    cap = min(cores, n)
    if mem_bytes is not None:
        peak = max(c.resident_bytes for c in costs)
        cap = min(cap, max(1, int(mem_bytes // max(peak, 1.0))))
        if cap <= 1:
            return SchedDecision(
                mode="serial", workers=1, est_pool_s=None,
                reason="available memory holds at most one resident trace",
                **base,
            )
    if device_mem_bytes is not None:
        per_worker = CUDA_CONTEXT_BYTES + max(c.device_bytes for c in costs)
        cap = min(cap, max(1, int(device_mem_bytes // per_worker)))
        if cap <= 1:
            return SchedDecision(
                mode="serial", workers=1, est_pool_s=None,
                reason="the card's free memory holds at most one worker",
                **base,
            )
    totals = [c.total_s for c in costs]
    best_p, best_s = 1, float("inf")
    for p in range(2, cap + 1):
        pool_s = (
            SPAWN_BASE_S + SPAWN_PER_WORKER_S * p + _lpt_makespan(totals, p)
        )
        if pool_s < best_s:
            best_p, best_s = p, pool_s
    if best_s >= serial_s:
        return SchedDecision(
            mode="serial", workers=1, est_pool_s=best_s,
            reason=(
                f"predicted pool time {best_s:.1f}s >= serial "
                f"{serial_s:.1f}s — spawn overhead exceeds parallel gain"
            ),
            **base,
        )
    return SchedDecision(
        mode="pipeline", workers=best_p, est_pool_s=best_s,
        reason=(
            f"predicted pool time {best_s:.1f}s at {best_p} workers beats "
            f"serial {serial_s:.1f}s"
        ),
        **base,
    )


def _available_mem_bytes() -> Optional[int]:
    """MemAvailable from /proc/meminfo, or None off-Linux."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def _available_device_bytes(device: torch.device) -> Optional[int]:
    """The card's free memory (None on the CPU)."""
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free)


def plan_execution(
    specs: Sequence,
    n_prefetchers: int,
    artifacts: Optional[ArtifactCache] = None,
    *,
    cores: Optional[int] = None,
    mem_bytes: Optional[int] = None,
    device: DeviceLike = None,
    device_mem_bytes: Optional[int] = None,
) -> SchedDecision:
    """Cost out ``specs`` against the artifact store and pick a mode.

    ``cores``/``mem_bytes``/``device_mem_bytes`` default to the live host
    and card (injectable for deterministic tests); ``device`` (default the
    CUDA card) is where the run's work goes.  This is what
    ``Experiment.run(workers=None)`` consults.
    """
    dev = resolve_device(device)
    artifacts = artifacts if artifacts is not None else ArtifactCache()
    if cores is None:
        cores = os.cpu_count() or 1
    if mem_bytes is None:
        mem_bytes = _available_mem_bytes()
    if device_mem_bytes is None:
        device_mem_bytes = _available_device_bytes(dev)
    unique = list(dict.fromkeys(specs))
    costs = [estimate_cost(s, n_prefetchers, artifacts) for s in unique]
    return decide(
        costs, cores=cores, mem_bytes=mem_bytes, device_mem_bytes=device_mem_bytes
    )


def rows_equal(a: List[dict], b: List[dict]) -> bool:
    """Exact equality of two ``ExperimentResult.rows()`` lists.

    The ``info`` entry holds prefetcher-side stats (scalars and numpy
    arrays) and is compared element-wise; every other metric must match
    bit-for-bit.  This is the parallel-vs-serial parity predicate.
    """
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if set(ra) != set(rb):
            return False
        for k in ra:
            va, vb = ra[k], rb[k]
            if k == "info":
                if set(va) != set(vb):
                    return False
                if not all(np.array_equal(va[ik], vb[ik]) for ik in va):
                    return False
            elif va != vb:
                return False
    return True


def graph_kernel_sources() -> list:
    """The CUDA sources the graph path launches (K1, K2, the ordered
    segment sum)."""
    from repro_torch.kernels.cache_sim.ops import SOURCES
    from repro_torch.kernels.segment_sum.segment_sum import SOURCE

    return list(SOURCES) + [SOURCE]


@contextlib.contextmanager
def _spawn_pool(
    artifacts: ArtifactCache, n_tasks: int, workers: int, device: torch.device
) -> Iterator[ProcessPoolExecutor]:
    """A spawned process pool with the engine's worker environment.

    Spawned interpreters re-import the package from scratch, so the parent
    exports: the ``repro_torch`` source root on ``PYTHONPATH``; the
    current cache-engine and trace-emitter selections, which may live in
    process-local state the children would never see; the trace directory
    of an active dir-backed tracer; and each worker's share of the cores
    for its intra-op thread pools.  On a card, the parent first builds the
    graph path's kernels (workers then load the built libraries).  The
    environment is restored when the pool closes.
    """
    if device.type == "cuda":
        from repro_torch.kernels import build

        build.build(graph_kernel_sources())
    pkg_dir = os.path.dirname(os.path.abspath(repro_torch.__file__))
    src_root = os.path.dirname(pkg_dir)
    old_pythonpath = os.environ.get("PYTHONPATH")
    pythonpath = [src_root] + ([old_pythonpath] if old_pythonpath else [])
    from repro_torch.apps.trace import EMITTER_ENV, current_emitter
    from repro_torch.memsim.engine import ENGINE_ENV, current_engine

    # ``workers`` is the requested width; the actual pool never exceeds
    # the task count or the core count — extra spawned processes on a
    # saturated host only add import/contention overhead.
    pool_size = max(1, min(workers, n_tasks, os.cpu_count() or workers))
    # Pin each worker's intra-op thread pools (torch's, OpenMP, BLAS) to
    # its share of the cores: each sizes its pool to the machine, so P
    # workers would oversubscribe a C-core host P-fold.
    threads = max(1, (os.cpu_count() or 1) // pool_size)
    child_env = {
        "PYTHONPATH": os.pathsep.join(pythonpath),
        "OMP_NUM_THREADS": str(threads),
        "OPENBLAS_NUM_THREADS": str(threads),
        "MKL_NUM_THREADS": str(threads),
        ENGINE_ENV: current_engine(),
        EMITTER_ENV: current_emitter(),
    }
    # When a dir-backed tracer is active, children join the trace: they
    # append spans to their own spans-worker-<pid>.jsonl under the trace
    # dir, and the parent's Tracer.finish() merges every file.
    tracer = obs.current_tracer()
    if tracer is not None and tracer.dir is not None:
        child_env[obs.SPAN_DIR_ENV] = str(tracer.dir)
        child_env[obs.TRACE_ID_ENV] = tracer.trace_id
    saved_env = {k: os.environ.get(k) for k in child_env}
    os.environ.update(child_env)
    try:
        ctx = get_context("spawn")
        with ProcessPoolExecutor(max_workers=pool_size, mp_context=ctx) as pool:
            yield pool
    finally:
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def run_grid(
    specs: Sequence[WorkloadSpec],
    prefetchers: Sequence[Tuple[str, object]],
    *,
    workers: int,
    artifacts: Optional[ArtifactCache] = None,
    verbose: bool = False,
    pipeline: bool = True,
    device: DeviceLike = None,
) -> Tuple[Dict[tuple, PrefetchMetrics], Dict[WorkloadSpec, WorkloadTrace]]:
    """Evaluate the (specs x prefetchers) grid across ``workers`` processes,
    each running its tasks on ``device`` (default the CUDA card).

    Returns ``({(spec, name): metrics}, {spec: trace})``, where the trace
    dict holds parent-side builds (none in the common path — every task's
    trace lands in the artifact store for on-demand loading).  The caller
    owns cell ordering (the metrics mapping is order-free, deterministic).

    ``pipeline=True`` (the default) overlaps materialization with scoring:
    a cold workload is submitted as a build-only task, and its prefetcher
    chunks are dispatched *the moment the build completes* — so warm
    workloads score while cold builds are still running, instead of the
    phased materialize-all-then-score-all schedule (``pipeline=False``,
    kept as the comparison baseline).  Both schedules produce bit-identical
    metrics; only the dispatch order differs.
    """
    dev = resolve_device(device)
    artifacts = artifacts if artifacts is not None else ArtifactCache()
    _check_picklable(prefetchers)
    if pipeline:
        return _run_grid_pipelined(
            specs, prefetchers, workers, artifacts, verbose, dev
        )

    unique, tasks = _plan(specs, prefetchers, workers, artifacts)

    # Longest-task-first dispatch: a heavy task submitted last would
    # serialize the tail of the run.  Artifact size x chunk length is the
    # cost proxy; a cold (unbuilt) workload is the most expensive unit of
    # all, so unknown costs rank first and the build overlaps the warm
    # work.  Execution order never affects results — cells are
    # reassembled by key.
    def _cost(task):
        spec = task[0]
        if getattr(spec, "is_sharded", False):
            # The manifest is tiny; rank by the trace length it describes
            # (8 bytes/access as the size proxy).  Unbuilt stores rank first.
            manifest = artifacts.load_manifest(spec)
            if manifest is None:
                return float("inf")
            return 8.0 * manifest["num_accesses"] * len(task[1])
        try:
            return artifacts.path_for(spec).stat().st_size * len(task[1])
        except OSError:
            return float("inf")

    tasks.sort(key=_cost, reverse=True)

    traces: Dict[WorkloadSpec, WorkloadTrace] = {}
    metrics: Dict[tuple, PrefetchMetrics] = {}
    with _spawn_pool(artifacts, len(tasks), workers, dev) as pool:
        futures = {
            pool.submit(
                _run_task, (i, spec, chunk, str(artifacts.root), str(dev))
            ): i
            for i, (spec, chunk) in enumerate(tasks)
        }
        for fut in as_completed(futures):
            index, scored = fut.result()
            spec = tasks[index][0]
            for name, m in scored:
                metrics[(spec, name)] = m
                if verbose:
                    _print_cell(spec, name, m)

    # Workers persisted their traces in the artifact store; the caller
    # loads them from there on demand.
    return metrics, traces


def _print_cell(spec, name, m) -> None:
    print(
        f"[{spec.kernel}/{spec.dataset}] {name}: "
        f"speedup {m.speedup:.2f} coverage {m.coverage:.2f} "
        f"accuracy {m.accuracy:.2f}"
    )


def _run_grid_pipelined(
    specs: Sequence[WorkloadSpec],
    prefetchers: Sequence[Tuple[str, object]],
    workers: int,
    artifacts: ArtifactCache,
    verbose: bool,
    device: torch.device,
) -> Tuple[Dict[tuple, PrefetchMetrics], Dict[WorkloadSpec, WorkloadTrace]]:
    """Overlap-pipelined grid execution (see :func:`run_grid`).

    Three task kinds flow through one pool: score chunks for warm
    workloads (dispatched immediately), build-only tasks for cold
    workloads (heaviest first), and the cold workloads' score chunks,
    dispatched as each build future resolves.  Sharded specs stay single
    build+score tasks — their bounded-memory scorer streams shards and
    never materializes a whole trace to hand off.  ``pipeline_overlap``
    accumulates the wall-time during which a build and a score task were
    in flight simultaneously — the saving over the phased schedule.
    """
    unique = list(dict.fromkeys(specs))
    target_tasks = max(2 * workers, len(unique))
    chunks_per = max(1, -(-target_tasks // len(unique)))  # ceil
    n_pf = len(prefetchers)
    root, dev = str(artifacts.root), str(device)

    warm, cold, whole = [], [], []
    for spec in unique:
        if getattr(spec, "is_sharded", False):
            whole.append(spec)
        elif artifacts.has(spec):
            warm.append(spec)
        else:
            cold.append(spec)
    cold.sort(
        key=lambda s: estimate_cost(s, n_pf, artifacts).total_s, reverse=True
    )

    tasks: List[tuple] = []  # (spec, chunk) per score task, by index
    metrics: Dict[tuple, PrefetchMetrics] = {}
    n_tasks_est = (
        len(whole) + (len(warm) + len(cold)) * chunks_per + len(cold)
    )
    overlap = 0.0
    with _spawn_pool(artifacts, n_tasks_est, workers, device) as pool:
        score_futs: set = set()
        build_futs: Dict[object, WorkloadSpec] = {}

        def submit_score(spec, n_chunks):
            for chunk in _split(prefetchers, n_chunks):
                index = len(tasks)
                tasks.append((spec, chunk))
                score_futs.add(
                    pool.submit(_run_task, (index, spec, chunk, root, dev))
                )

        for spec in whole:
            submit_score(spec, 1)
        for spec in warm:
            submit_score(spec, chunks_per)
        for i, spec in enumerate(cold):
            fut = pool.submit(_materialize_task, (i, spec, root, dev))
            build_futs[fut] = spec

        while score_futs or build_futs:
            both_in_flight = bool(score_futs) and bool(build_futs)
            t0 = time.perf_counter()
            done, _ = wait(
                score_futs | set(build_futs), return_when=FIRST_COMPLETED
            )
            if both_in_flight:
                overlap += time.perf_counter() - t0
            for fut in done:
                if fut in build_futs:
                    fut.result()  # surface worker exceptions
                    spec = build_futs.pop(fut)
                    # The artifact just landed; its scoring can now split
                    # across the pool like any warm workload.
                    submit_score(spec, chunks_per)
                else:
                    score_futs.discard(fut)
                    index, scored = fut.result()
                    spec = tasks[index][0]
                    for name, m in scored:
                        metrics[(spec, name)] = m
                        if verbose:
                            _print_cell(spec, name, m)
    record("pipeline_overlap", overlap)
    return metrics, {}


def _materialize_task(task) -> int:
    """Worker body: build-or-load one trace into the artifact store."""
    index, spec, cache_root, device = task
    try:
        _materialize(spec, cache_root, device)
    finally:
        obs.flush_worker_metrics()
    return index


class MaterializePipeline:
    """Background builds with as-ready handoff to an in-parent scorer.

    The streaming and serving protocols must *score* sequentially in the
    parent (the cross-epoch table lifecycle and the shared-LLC interleave
    live there) but their traces are independent *builds*.  This object
    fans the builds across a spawned pool and lets the scorer block on
    exactly the trace it needs next (:meth:`wait`), so epoch 0 scores
    while epochs 1..E are still building.

    Builds are deduplicated by artifact path, which under content-keyed
    specs collapses epochs whose graph the churn model left unchanged into
    a single in-flight build.  ``n_built``/``n_reused`` report that split.
    Specs already in the artifact store spawn no pool work at all; a
    fully-warm pipeline never starts a pool.  Builds run on ``device``
    (default the CUDA card).

    The wall-time the parent spends scoring while builds are still in
    flight accumulates under the ``pipeline_overlap`` stage key.
    """

    def __init__(
        self,
        specs: Sequence,
        *,
        workers: int,
        artifacts: ArtifactCache,
        device: DeviceLike = None,
    ):
        dev = resolve_device(device)
        self.artifacts = artifacts
        unique = list(dict.fromkeys(specs))
        by_path: Dict[str, object] = {}
        for s in unique:
            by_path.setdefault(str(artifacts.path_for(s)), s)
        todo = [
            (path, s) for path, s in by_path.items() if not artifacts.has(s)
        ]
        self.n_specs = len(unique)
        self.n_built = len(todo)
        self.n_reused = self.n_specs - self.n_built
        self._futures: Dict[str, object] = {}
        self._stack: Optional[contextlib.ExitStack] = None
        self._last_handoff: Optional[float] = None
        if todo:
            self._stack = contextlib.ExitStack()
            pool = self._stack.enter_context(
                _spawn_pool(artifacts, len(todo), workers, dev)
            )
            # FIFO submission: the scorer consumes epochs in sequence
            # order, so the build it will wait on first starts first.
            for i, (path, spec) in enumerate(todo):
                self._futures[path] = pool.submit(
                    _materialize_task,
                    (i, spec, str(self.artifacts.root), str(dev)),
                )

    def wait(self, spec) -> None:
        """Block until ``spec``'s trace is in the artifact store."""
        now = time.perf_counter()
        if self._last_handoff is not None and any(
            not f.done() for f in self._futures.values()
        ):
            # Parent-side work since the last handoff ran concurrently
            # with at least one build — the pipeline's saving.
            record("pipeline_overlap", now - self._last_handoff)
        path = self.artifacts.path_for(spec)
        fut = self._futures.get(str(path))
        with obs.span(
            "pipeline_handoff",
            cache_key=path.name,
            built=fut is not None,
        ):
            if fut is not None:
                fut.result()
        self._last_handoff = time.perf_counter()

    def close(self) -> None:
        """Drain remaining builds and shut the pool down."""
        try:
            for fut in self._futures.values():
                fut.result()
        finally:
            if self._stack is not None:
                self._stack.close()
                self._stack = None


def materialize_specs(
    specs: Sequence[WorkloadSpec],
    *,
    workers: int,
    artifacts: Optional[ArtifactCache] = None,
    device: DeviceLike = None,
) -> int:
    """Fan workload builds (no scoring) across a spawned pool.

    The barrier form of :class:`MaterializePipeline` — build everything,
    then return.  Already-materialized specs are skipped.  Returns the
    number of traces built.
    """
    artifacts = artifacts if artifacts is not None else ArtifactCache()
    pipe = MaterializePipeline(
        specs, workers=workers, artifacts=artifacts, device=device
    )
    pipe.close()
    return pipe.n_built


__all__ = [
    "MaterializePipeline",
    "SchedDecision",
    "TaskCost",
    "decide",
    "estimate_cost",
    "materialize_specs",
    "plan_execution",
    "rows_equal",
    "run_grid",
]
