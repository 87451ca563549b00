"""Structured span tracing with cross-process collection (ported from
``repro.core.obs.spans``).

One *span* is a named, timed event with attributes — the structured
successor of the flat ``{stage: seconds}`` dict.  Spans carry a trace id,
a span id, a parent span id (the enclosing span at open time, per
process), a wall-clock start timestamp (``time.time_ns`` — comparable
across processes), a high-resolution duration (``perf_counter`` delta),
the recording pid, and free-form attributes (cache hit/miss, engine
choice, ...).

Three layers of state, all with a no-op fast path so the hot paths pay
nothing when telemetry is off:

- **Stage collector** (``collect_stages``): the flat dict.  :func:`stage`
  accumulates durations into it, and nested collectors shadow outer ones
  for their extent.
- **Tracer** (``trace``): records :class:`Span` objects.  :func:`stage`
  doubles as a span when a tracer is active, so every stage site shows up
  on the timeline; :func:`span` is the attribute-bearing form.
- **Metrics registry**: the active tracer owns a
  :class:`~repro_torch.core.obs.metrics.MetricsRegistry`; :func:`stage`
  feeds per-stage latency histograms, and :func:`inc` feeds counters from
  anywhere.

:func:`span` has a second sink: while ``torch.profiler`` records, it also
opens ``torch.profiler.record_function(name)``, so the span lies on the
profiler's clock, in the same trace as the device's timeline, and each
kernel can be charged to the span open on the host when it was launched.

Clocks.  A span's or stage's own duration is the host's clock.  It covers
the device work only where the block ends by copying its device results
to the host, as the graph path's stages do.  The model path
(``models/``, ``launch/steps.py``) returns with its kernels still queued,
so its spans' host durations are enqueue intervals; their device time is
read from the profiler's trace.

Cross-process collection: a :class:`Tracer` opened with a directory
exports nothing itself; a process that finds :data:`SPAN_DIR_ENV` /
:data:`TRACE_ID_ENV` set lazily opens a *file-backed worker tracer*
appending one JSON line per closed span to its own
``spans-<pid>.jsonl``.  The parent's :meth:`Tracer.finish` merges every
per-process file deterministically into one :class:`RunTrace`.  The
variables carry the port's own names (``REPRO_TORCH_TRACE_*``), so a run
of the JAX package and a run of the port in one shell never share a
trace.  (The process pool that publishes them is the scheduler, ROADMAP
queue 1 item 4.)
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import uuid
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

from repro_torch.core.obs.metrics import MetricsRegistry, merge_snapshots

SPAN_DIR_ENV = "REPRO_TORCH_TRACE_DIR"
TRACE_ID_ENV = "REPRO_TORCH_TRACE_ID"

# Version of the span/metrics line format written to trace dirs (and of
# the merged RunTrace document).
TRACE_SCHEMA = 1

_STAGES: Optional[Dict[str, float]] = None  # active stage collector
_METRICS: Optional[MetricsRegistry] = None  # explicit registry override
_TRACER: Optional["Tracer"] = None
_WORKER_PROBED = False  # lazily checked SPAN_DIR_ENV once in this process


@dataclasses.dataclass
class Span:
    """One structured, timed event."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    ts: int  # wall-clock start, ns since the epoch (cross-process axis)
    dur: float  # seconds, from a perf_counter delta (high resolution)
    pid: int
    proc: str  # process label: "main" or "worker"
    attrs: Dict[str, object]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(**d)


class Tracer:
    """Span recorder for one process.

    The parent opens one via :func:`trace` (buffering spans in memory and
    flushing them to ``spans-<pid>.jsonl`` at :meth:`finish`); spawned
    workers open file-backed ones lazily from :data:`SPAN_DIR_ENV`,
    appending each span as it closes so a worker needs no shutdown hook.
    """

    def __init__(
        self,
        trace_id: Optional[str] = None,
        dir: Optional[os.PathLike] = None,
        proc: str = "main",
    ):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.dir = Path(dir) if dir is not None else None
        self.proc = proc
        self.pid = os.getpid()
        self.spans: List[Span] = []
        self.metrics = MetricsRegistry()
        self.result: Optional["RunTrace"] = None
        self._stack: List[str] = []  # open span ids (per-process parentage)
        self._seq = 0
        self._metrics_seq = 0
        self._stream = None  # append-mode file (worker tracers)
        if self.dir is not None:
            self.dir.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------ recording

    def _next_id(self) -> str:
        self._seq += 1
        return f"{self.pid:x}-{self._seq:x}"

    def open_span(self, name: str, attrs: Dict[str, object]) -> Span:
        s = Span(
            name=name,
            trace_id=self.trace_id,
            span_id=self._next_id(),
            parent_id=self._stack[-1] if self._stack else None,
            ts=time.time_ns(),
            dur=0.0,
            pid=self.pid,
            proc=self.proc,
            attrs=dict(attrs),
        )
        self._stack.append(s.span_id)
        return s

    def close_span(self, s: Span, dur: float) -> None:
        s.dur = dur
        if self._stack and self._stack[-1] == s.span_id:
            self._stack.pop()
        self.spans.append(s)
        if self._stream is not None:
            self._write_line(s.as_dict())

    # --------------------------------------------------------------- files

    def _path(self) -> Path:
        assert self.dir is not None
        return self.dir / f"spans-{self.proc}-{self.pid}.jsonl"

    def _write_line(self, doc: dict) -> None:
        self._stream.write(json.dumps(doc, sort_keys=True) + "\n")
        self._stream.flush()

    def open_stream(self) -> None:
        """Switch to append-per-span mode (worker tracers): a pool worker
        has no reliable shutdown hook, so every closed span lands on disk
        immediately."""
        if self.dir is not None and self._stream is None:
            self._stream = open(self._path(), "a")

    def flush_metrics(self) -> None:
        """Write this process's *cumulative* metrics snapshot as a line.

        Workers call this at task boundaries.  Snapshots are cumulative
        (monotonic per process), so the merge keeps only the last line
        per pid and sums across pids — no delta bookkeeping, and a lost
        tail only loses the most recent increments.
        """
        if self._stream is None or not self.metrics:
            return
        self._metrics_seq += 1
        self._write_line(
            {
                "kind": "metrics",
                "pid": self.pid,
                "proc": self.proc,
                "seq": self._metrics_seq,
                "metrics": self.metrics.snapshot(),
            }
        )

    def finish(self, manifest: Optional[dict] = None) -> "RunTrace":
        """Flush this process's spans/metrics and merge the trace dir.

        Idempotent: repeat calls return the same :class:`RunTrace`.
        """
        if self.result is not None:
            return self.result
        if self.dir is not None:
            self.open_stream()
            for s in self.spans:
                self._write_line(s.as_dict())
            self.flush_metrics()
            self._stream.close()
            self._stream = None
            self.result = RunTrace.load(self.dir, manifest=manifest)
        else:
            self.result = RunTrace(
                trace_id=self.trace_id,
                spans=_sorted_spans(list(self.spans)),
                metrics=merge_snapshots([self.metrics.snapshot()]),
                manifest=manifest,
            )
        return self.result


@dataclasses.dataclass
class RunTrace:
    """A merged, ordered view over every process's spans for one run."""

    trace_id: str
    spans: List[Span]
    metrics: dict  # merged MetricsRegistry snapshot
    manifest: Optional[dict] = None

    @classmethod
    def load(cls, dir: os.PathLike, manifest: Optional[dict] = None) -> "RunTrace":
        """Deterministically merge every ``spans-*.jsonl`` under ``dir``.

        Span order is (wall start ns, pid, span id) — fully determined by
        the files' contents, independent of filesystem listing order or
        how many times the merge runs.  Metrics lines are cumulative per
        process: the last one per pid wins, then pids merge in sorted
        order (counters/histograms sum, gauges last-writer-by-pid).
        Unparseable lines (a worker killed mid-write) are dropped, never
        fatal.
        """
        spans: List[Span] = []
        trace_id = ""
        last_metrics: Dict[int, tuple] = {}  # pid -> (seq, snapshot)
        for path in sorted(Path(dir).glob("spans-*.jsonl")):
            for line in path.read_text().splitlines():
                try:
                    doc = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if doc.get("kind") == "metrics":
                    pid, seq = int(doc["pid"]), int(doc["seq"])
                    if pid not in last_metrics or seq > last_metrics[pid][0]:
                        last_metrics[pid] = (seq, doc["metrics"])
                    continue
                try:
                    s = Span.from_dict(doc)
                except TypeError:
                    continue
                spans.append(s)
                trace_id = trace_id or s.trace_id
        merged = merge_snapshots(
            [snap for _, (_, snap) in sorted(last_metrics.items())]
        )
        return cls(
            trace_id=trace_id,
            spans=_sorted_spans(spans),
            metrics=merged,
            manifest=manifest,
        )

    # ------------------------------------------------------------- queries

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def processes(self) -> List[tuple]:
        """Sorted distinct (pid, proc) pairs that contributed spans."""
        return sorted({(s.pid, s.proc) for s in self.spans})

    def stage_totals(self) -> Dict[str, float]:
        """Per-name duration sums — the flat stage dict, derived."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.dur
        return out

    # ----------------------------------------------------------------- io

    def as_dict(self) -> dict:
        return {
            "schema": "run-trace",
            "version": TRACE_SCHEMA,
            "trace_id": self.trace_id,
            "manifest": self.manifest,
            "metrics": self.metrics,
            "spans": [s.as_dict() for s in self.spans],
        }

    def save(self, path: os.PathLike) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def read(cls, path: os.PathLike) -> "RunTrace":
        with open(path) as f:
            doc = json.load(f)
        if doc.get("schema") != "run-trace":
            raise ValueError(f"{path}: not a run-trace document")
        return cls(
            trace_id=doc["trace_id"],
            spans=[Span.from_dict(d) for d in doc["spans"]],
            metrics=doc.get("metrics") or {},
            manifest=doc.get("manifest"),
        )


def _sorted_spans(spans: List[Span]) -> List[Span]:
    return sorted(spans, key=lambda s: (s.ts, s.pid, s.span_id))


# ------------------------------------------------------------ active state


def _probe_worker_tracer() -> Optional[Tracer]:
    """Lazily open a file-backed tracer when the parent exported a trace
    dir to this (spawned) process.  Checked once per process; the result
    is cached in ``_TRACER``."""
    global _TRACER, _WORKER_PROBED
    if _TRACER is not None:
        return _TRACER
    if _WORKER_PROBED:
        return None
    _WORKER_PROBED = True
    dir = os.environ.get(SPAN_DIR_ENV)
    if not dir:
        return None
    _TRACER = Tracer(
        trace_id=os.environ.get(TRACE_ID_ENV), dir=dir, proc="worker"
    )
    _TRACER.open_stream()
    return _TRACER


def current_tracer() -> Optional[Tracer]:
    """The active tracer: an explicit :func:`trace` context, else a
    worker tracer adopted from the environment, else None."""
    return _TRACER if _TRACER is not None else _probe_worker_tracer()


def tracing() -> bool:
    return current_tracer() is not None


def current_metrics() -> Optional[MetricsRegistry]:
    """The active metrics registry: an explicit :func:`metrics_registry`
    context shadows the active tracer's registry."""
    if _METRICS is not None:
        return _METRICS
    t = current_tracer()
    return t.metrics if t is not None else None


@contextlib.contextmanager
def trace(
    dir: Optional[os.PathLike] = None,
    trace_id: Optional[str] = None,
) -> Iterator[Tracer]:
    """Activate span collection for the enclosed block.

    With ``dir``, the trace is cross-process capable: the pool spawner
    exports the dir to workers, each process appends its own JSONL file,
    and ``tracer.finish()`` (called automatically on exit; idempotent)
    merges them into ``tracer.result``.  Without ``dir`` the trace is
    in-process only (cheap, for tests and ad-hoc timing).  Nested traces
    shadow outer ones for their extent, like stage collectors.
    """
    global _TRACER
    t = Tracer(trace_id=trace_id, dir=dir)
    prev, _TRACER = _TRACER, t
    try:
        yield t
    finally:
        _TRACER = prev
        t.finish()


@contextlib.contextmanager
def metrics_registry(
    into: Optional[MetricsRegistry] = None,
) -> Iterator[MetricsRegistry]:
    """Activate a standalone metrics registry (no tracer required)."""
    global _METRICS
    reg = into if into is not None else MetricsRegistry()
    prev, _METRICS = _METRICS, reg
    try:
        yield reg
    finally:
        _METRICS = prev


# ----------------------------------------------------- instrumentation API


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Optional[Span]]:
    """Record one attribute-bearing span: into the active tracer, and as
    ``record_function(name)`` while ``torch.profiler`` records (no-op with
    neither).

    Yields the open :class:`Span` so call sites can attach attributes
    discovered mid-flight (``sp.attrs["cache"] = "hit"``), or ``None``
    when no tracer is active — guard late-attr writes with ``if sp:``.
    """
    tracer = current_tracer()
    profiling = torch.autograd._profiler_enabled()
    if tracer is None and not profiling:
        yield None
        return
    with torch.profiler.record_function(name) if profiling else contextlib.nullcontext():
        if tracer is None:
            yield None
            return
        s = tracer.open_span(name, attrs)
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            tracer.close_span(s, time.perf_counter() - t0)


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Accumulate this block's duration under ``name``.

    The legacy stage-timer contract, unchanged: with an active
    :func:`collect_stages` collector the duration accumulates into its
    dict (bit-identical to the pre-span implementation — one
    ``perf_counter`` delta, added once).  Additionally, when a tracer is
    active the same interval is recorded as a span of the same name (the
    one measured duration is shared, so ``RunTrace.stage_totals()``
    equals the collector dict exactly), and when a metrics registry is
    active the duration feeds the ``stage.<name>`` latency histogram.
    With none of the three active this is a no-op.
    """
    tracer = current_tracer()
    reg = _METRICS if _METRICS is not None else (
        tracer.metrics if tracer is not None else None
    )
    if _STAGES is None and tracer is None and reg is None:
        yield
        return
    s = tracer.open_span(name, {}) if tracer is not None else None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if s is not None:
            tracer.close_span(s, dt)
        if _STAGES is not None:
            _STAGES[name] = _STAGES.get(name, 0.0) + dt
        if reg is not None:
            reg.observe(f"stage.{name}", dt)


@contextlib.contextmanager
def collect_stages(
    into: Optional[Dict[str, float]] = None,
) -> Iterator[Dict[str, float]]:
    """Collect ``stage()`` durations from the enclosed block into a dict.

    Durations accumulate per stage name, so a block that builds several
    workloads reports total seconds spent in each pipeline stage.  Nested
    collectors shadow outer ones for their extent.
    """
    global _STAGES
    times = into if into is not None else {}
    prev, _STAGES = _STAGES, times
    try:
        yield times
    finally:
        _STAGES = prev


def record(name: str, value: float = 1.0) -> None:
    """Accumulate ``value`` under ``name`` in the active stage collector.

    The out-of-band counterpart of :func:`stage` for durations or counts
    with no contiguous block to wrap (pipeline overlap windows, scheduler
    decisions).  Also feeds the active metrics registry as a counter.
    No-op when neither is active.
    """
    if _STAGES is not None:
        _STAGES[name] = _STAGES.get(name, 0.0) + value
    reg = current_metrics()
    if reg is not None:
        reg.inc(name, value)


def inc(name: str, value: float = 1.0) -> None:
    """Increment counter ``name`` in the active registry (no-op off)."""
    reg = current_metrics()
    if reg is not None:
        reg.inc(name, value)


def flush_worker_metrics() -> None:
    """Flush the worker tracer's cumulative metrics snapshot (task
    boundaries call this so parent merges see worker-side counters)."""
    t = current_tracer()
    if t is not None and t._stream is not None:
        t.flush_metrics()


def _reset_for_tests() -> None:
    """Drop all active state incl. the worker-env probe (test helper)."""
    global _STAGES, _METRICS, _TRACER, _WORKER_PROBED
    _STAGES = None
    _METRICS = None
    _TRACER = None
    _WORKER_PROBED = False


__all__ = [
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
    "metrics_registry",
    "record",
    "span",
    "stage",
    "trace",
    "tracing",
]
