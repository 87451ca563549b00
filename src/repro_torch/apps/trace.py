"""Memory-trace generation: app run -> access streams, both directions.

**Push (sparse EDGEMAP, Fig 3).**  For every active source vertex v
(processed in frontier order, as Ligra's sparse vertexSubset does):

    F[v]          frontier check                   (frontier array)
    T[v]          target read (delta/label/dist)   (TARGET data structure)
    V[v], V[v+1]  CSR row bounds (same line or adjacent)
    for e in row(v):  N[e]   edge read
                      P[dst] neighbor property update   <- the misses

**Pull (dense EDGEMAP).**  A dense iteration first scans the frontier
bitmap sequentially (Ligra materializes the dense vertexSubset), then
every destination vertex d walks its in-edge row:

    F[0..n-1]     dense frontier scan              (sequential)
    per d: T[d]   own target read                  (sequential)
           V[d]   CSC row bound                    (sequential)
           for e in in_row(d):  NI[e]    in-edge read   (sequential)
                                P[src]   source-property gather  <- the misses

Direction changes the miss *structure* AMC sees: push scatters property
writes to destinations behind sequential out-edge reads; pull scatters
property reads from sources behind sequential in-edge reads, with the
frontier/target/offset streams turning fully sequential.  A
direction-optimizing run (``bfs_do``) alternates the two modalities.

The paper's AMC registers mark T's range (AddrTBase) and F's range
(AddrFBase); everything is emitted as *addresses* so range filtering happens
exactly as in hardware. Element sizes: F 1B (ligra bool frontier), T 8B,
V 8B, N 4B, P 8B, NI 4B; arrays live in disjoint page-aligned regions.

**Emitters.**  :func:`trace_run` emits a whole run as one
:class:`RunTrace` — boundary-offset arrays over one concatenated stream.
Two emitters (pick with ``REPRO_TORCH_TRACE_EMITTER``, :func:`set_emitter`, or
:func:`use_emitter`), mirroring the cache-engine pattern in
:mod:`repro_torch.memsim.engine`:

- ``batched`` (default): one vectorized pass over all iterations — the
  concatenated-frontier cumsum layout per run, no per-iteration Python
  loop.  Bit-identical to the reference (test- and bench-gated).
- ``reference``: the original per-iteration path
  (:func:`trace_app_run` + concatenation), kept as the correctness oracle.

Traces are numpy struct-of-arrays; the cache simulator consumes the 64-bit
block ids.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.apps.ligra import AppRun
from repro_torch.graphs.csr import CSRGraph

BLOCK_BITS = 6  # 64B lines
PAGE_BITS = 12  # 4KB pages

# array id -> (symbol, element size in bytes)
ARRAYS: Dict[int, tuple] = {
    0: ("F", 1),  # frontier bitmap
    1: ("T", 8),  # target (delta / label / dist) -- AddrTBase range
    2: ("V", 8),  # CSR/CSC offsets (of the traversal direction in use)
    3: ("N", 4),  # out-edge/neighbor array (push traversal)
    4: ("P", 8),  # vertex property (push destination / pull source)
    5: ("NI", 4),  # in-edge array (pull traversal; the CSC neighbor list)
}
F_ID, T_ID, V_ID, N_ID, P_ID, NI_ID = 0, 1, 2, 3, 4, 5

# The paper's application input footprint (V+N+P+F+T) — the storage-overhead
# denominator.  The in-edge array is a runtime-derived view (Ligra builds it
# from the input), so it is addressable but not counted as input.
_INPUT_ARRAY_IDS = (F_ID, T_ID, V_ID, N_ID, P_ID)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Address-space layout for one app instance."""

    num_vertices: int
    num_edges: int
    base: int = 0x1000_0000

    def _sizes(self) -> Dict[int, int]:
        return {
            F_ID: self.num_vertices * 1,
            T_ID: self.num_vertices * 8,
            V_ID: (self.num_vertices + 1) * 8,
            N_ID: self.num_edges * 4,
            P_ID: self.num_vertices * 8,
            NI_ID: self.num_edges * 4,
        }

    def region(self, array_id: int) -> tuple:
        """(base_addr, size_bytes) for an array, page aligned regions.

        Regions are laid out in array-id order, so appending NI after P
        left every pre-existing (push) address unchanged.
        """
        sizes = self._sizes()
        addr = self.base
        for aid in range(array_id):
            size = sizes[aid]
            pages = -(-size // (1 << PAGE_BITS)) + 1  # +1 guard page
            addr += pages << PAGE_BITS
        return addr, sizes[array_id]

    @functools.cached_property
    def _addr_lut(self) -> tuple:
        """(bases, elem_sizes) int64 lookup tables indexed by array id."""
        ids = sorted(ARRAYS)
        bases = np.array([self.region(a)[0] for a in ids], dtype=np.int64)
        esize = np.array([ARRAYS[a][1] for a in ids], dtype=np.int64)
        return bases, esize

    def addr(self, array_id: np.ndarray, elem: np.ndarray) -> np.ndarray:
        """Byte address per access — one lookup-table-indexed expression
        (base[id] + elem * elem_size[id]) instead of a per-array Python
        loop; bit-identical to the loop it replaced."""
        bases, esize = self._addr_lut
        aid = np.asarray(array_id, dtype=np.int64)
        return bases[aid] + np.asarray(elem, dtype=np.int64) * esize[aid]

    @property
    def target_range(self) -> tuple:
        return self.region(T_ID)

    @property
    def frontier_range(self) -> tuple:
        return self.region(F_ID)

    @property
    def input_bytes(self) -> int:
        """Application input footprint (V+N+P+F+T) for storage-overhead %."""
        return sum(self.region(a)[1] for a in _INPUT_ARRAY_IDS)


@dataclasses.dataclass
class IterationTrace:
    """One iteration's access stream (struct of arrays)."""

    array_id: np.ndarray  # int8
    elem: np.ndarray  # int64 element index
    addr: np.ndarray  # int64 byte address
    block: np.ndarray  # int64 cache-line id (addr >> 6)
    src_vertex: np.ndarray  # int64: vertex whose processing owns this access
    iteration: int

    def __len__(self) -> int:
        return len(self.addr)

    @property
    def is_target(self) -> np.ndarray:
        return self.array_id == T_ID

    @property
    def is_frontier(self) -> np.ndarray:
        return self.array_id == F_ID


@dataclasses.dataclass
class RunTrace:
    """A whole app run's access stream: one concatenated struct-of-arrays
    with per-iteration boundary offsets (``iter_bounds[i] : iter_bounds[i+1]``
    is iteration ``i``'s slice)."""

    array_id: np.ndarray  # int8
    elem: np.ndarray  # int64
    addr: np.ndarray  # int64
    block: np.ndarray  # int64
    src_vertex: np.ndarray  # int64
    iter_bounds: np.ndarray  # int64, (num_iters + 1,)
    directions: List[str]  # per-iteration traversal direction

    def __len__(self) -> int:
        return len(self.addr)

    @property
    def num_iters(self) -> int:
        return len(self.iter_bounds) - 1

    @property
    def iter_sizes(self) -> np.ndarray:
        return np.diff(self.iter_bounds)

    def iteration(self, i: int) -> IterationTrace:
        """Zero-copy view of one iteration's slice."""
        lo, hi = self.iter_bounds[i], self.iter_bounds[i + 1]
        return IterationTrace(
            array_id=self.array_id[lo:hi],
            elem=self.elem[lo:hi],
            addr=self.addr[lo:hi],
            block=self.block[lo:hi],
            src_vertex=self.src_vertex[lo:hi],
            iteration=i,
        )


# ------------------------------------------------------ emitter selection

EMITTERS = ("batched", "reference")
EMITTER_ENV = "REPRO_TORCH_TRACE_EMITTER"
DEFAULT_EMITTER = "batched"

_emitter_override: Optional[str] = None


def _check_emitter(name: str) -> str:
    if name not in EMITTERS:
        raise ValueError(f"unknown trace emitter {name!r}; choose from {EMITTERS}")
    return name


def current_emitter() -> str:
    """The active emitter: ``set_emitter`` override > env var > default."""
    if _emitter_override is not None:
        return _emitter_override
    return _check_emitter(os.environ.get(EMITTER_ENV, DEFAULT_EMITTER))


def set_emitter(name: Optional[str]) -> None:
    """Select the trace emitter process-wide (``None`` restores env/default)."""
    global _emitter_override
    _emitter_override = _check_emitter(name) if name is not None else None


@contextlib.contextmanager
def use_emitter(name: str) -> Iterator[None]:
    """Run the enclosed block under a specific trace emitter."""
    global _emitter_override
    prev, _emitter_override = _emitter_override, _check_emitter(name)
    try:
        yield
    finally:
        _emitter_override = prev


# -------------------------------------------------- per-iteration (reference)


def _iteration_trace(
    graph: CSRGraph, active: np.ndarray, cfg: TraceConfig, iteration: int
) -> IterationTrace:
    """Sparse (push) iteration: frontier-ordered per-source blocks."""
    offsets = graph.offsets
    neighbors = graph.neighbors
    k = len(active)
    deg = (offsets[active + 1] - offsets[active]).astype(np.int64)
    e_total = int(deg.sum())
    lengths = 3 + 2 * deg  # F,T,V headers + interleaved N,P
    starts = np.zeros(k, dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    total = int(lengths.sum())

    array_id = np.empty(total, dtype=np.int8)
    elem = np.empty(total, dtype=np.int64)
    src_vertex = np.empty(total, dtype=np.int64)

    # Headers.
    array_id[starts] = F_ID
    array_id[starts + 1] = T_ID
    array_id[starts + 2] = V_ID
    for off in range(3):
        elem[starts + off] = active
        src_vertex[starts + off] = active

    if e_total:
        owner = np.repeat(np.arange(k, dtype=np.int64), deg)
        e_rank = np.arange(e_total, dtype=np.int64)
        deg_cum = np.zeros(k, dtype=np.int64)
        np.cumsum(deg[:-1], out=deg_cum[1:])
        j = e_rank - deg_cum[owner]  # edge index within the vertex row
        edge_global = offsets[active[owner]] + j  # position in N array
        dsts = neighbors[edge_global]
        pos_n = starts[owner] + 3 + 2 * j
        pos_p = pos_n + 1
        array_id[pos_n] = N_ID
        elem[pos_n] = edge_global
        src_vertex[pos_n] = active[owner]
        array_id[pos_p] = P_ID
        elem[pos_p] = dsts
        src_vertex[pos_p] = active[owner]

    addr = cfg.addr(array_id, elem)
    return IterationTrace(
        array_id=array_id,
        elem=elem,
        addr=addr,
        block=addr >> BLOCK_BITS,
        src_vertex=src_vertex,
        iteration=iteration,
    )


def _pull_body(graph: CSRGraph) -> tuple:
    """The (array_id, elem, src_vertex) arrays of one dense iteration.

    A dense (pull) iteration's access stream is frontier-independent — the
    full bitmap scan plus every destination's complete in-edge walk — so
    the body is built once per graph and cached on the instance; only the
    address mapping (and the owning iteration id) varies per use.
    """
    cached = graph.__dict__.get("_pull_trace_body")
    if cached is not None:
        return cached
    t = graph.transpose()
    n = graph.num_vertices
    m = t.num_edges
    indeg = t.degrees.astype(np.int64)
    vid = np.arange(n, dtype=np.int64)
    lengths = 2 + 2 * indeg  # T,V headers + interleaved NI,P per destination
    starts = np.empty(n, dtype=np.int64)
    starts[0] = n  # per-destination blocks follow the n-long frontier scan
    np.cumsum(lengths[:-1], out=starts[1:])
    starts[1:] += n
    total = n + int(lengths.sum())

    array_id = np.empty(total, dtype=np.int8)
    elem = np.empty(total, dtype=np.int64)
    src_vertex = np.empty(total, dtype=np.int64)

    # Dense frontier scan: F[0..n-1], sequential.
    array_id[:n] = F_ID
    elem[:n] = vid
    src_vertex[:n] = vid

    # Per-destination headers: own target read + CSC row bound.
    array_id[starts] = T_ID
    array_id[starts + 1] = V_ID
    for off in range(2):
        elem[starts + off] = vid
        src_vertex[starts + off] = vid

    if m:
        owner = np.repeat(vid, indeg)  # destination d per in-edge
        e_rank = np.arange(m, dtype=np.int64)  # CSC in-edge positions
        j = e_rank - np.repeat(t.offsets[:-1].astype(np.int64), indeg)
        pos_ni = starts[owner] + 2 + 2 * j
        pos_p = pos_ni + 1
        array_id[pos_ni] = NI_ID
        elem[pos_ni] = e_rank
        src_vertex[pos_ni] = owner
        array_id[pos_p] = P_ID
        elem[pos_p] = t.neighbors[e_rank].astype(np.int64)  # source gather
        src_vertex[pos_p] = owner

    body = (array_id, elem, src_vertex)
    object.__setattr__(graph, "_pull_trace_body", body)
    return body


def _iteration_trace_pull(
    graph: CSRGraph, active: np.ndarray, cfg: TraceConfig, iteration: int
) -> IterationTrace:
    """Dense (pull) iteration — ``active`` does not shape the stream (the
    dense EDGEMAP scans everything); it is accepted for signature symmetry."""
    array_id, elem, src_vertex = _pull_body(graph)
    addr = cfg.addr(array_id, elem)
    return IterationTrace(
        array_id=array_id,
        elem=elem,
        addr=addr,
        block=addr >> BLOCK_BITS,
        src_vertex=src_vertex,
        iteration=iteration,
    )


def trace_app_run(run: AppRun, cfg: TraceConfig | None = None) -> List[IterationTrace]:
    """Per-iteration traces for an app run (the reference emitter's path)."""
    g = run.graph
    cfg = cfg or TraceConfig(num_vertices=g.num_vertices, num_edges=g.num_edges)
    dirs = run.iteration_directions()
    return [
        (_iteration_trace_pull if d == "pull" else _iteration_trace)(g, f, cfg, i)
        for i, (f, d) in enumerate(zip(run.frontiers, dirs))
    ]


# ------------------------------------------------------- whole-run emission


def trace_run(run: AppRun, cfg: TraceConfig | None = None) -> RunTrace:
    """Emit the whole run's access stream under the active emitter."""
    g = run.graph
    cfg = cfg or TraceConfig(num_vertices=g.num_vertices, num_edges=g.num_edges)
    if current_emitter() == "reference":
        return _trace_run_reference(run, cfg)
    return _trace_run_batched(run, cfg)


def _trace_run_reference(run: AppRun, cfg: TraceConfig) -> RunTrace:
    """Reference oracle: per-iteration traces, concatenated."""
    traces = trace_app_run(run, cfg)
    sizes = np.array([len(t) for t in traces], dtype=np.int64)
    bounds = np.zeros(len(traces) + 1, dtype=np.int64)
    np.cumsum(sizes, out=bounds[1:])

    def cat(field: str, dtype) -> np.ndarray:
        if not traces:
            return np.zeros(0, dtype=dtype)
        return np.concatenate([getattr(t, field) for t in traces])

    return RunTrace(
        array_id=cat("array_id", np.int8),
        elem=cat("elem", np.int64),
        addr=cat("addr", np.int64),
        block=cat("block", np.int64),
        src_vertex=cat("src_vertex", np.int64),
        iter_bounds=bounds,
        directions=list(run.iteration_directions()),
    )


def _pull_body_addressed(graph: CSRGraph, cfg: TraceConfig) -> tuple:
    """The dense-iteration body with its (addr, block) arrays, cached per
    (graph, layout).  A direction-optimizing run replays the same dense
    body every pull iteration; the reference emitter recomputes its
    addresses each time, the batched emitter maps them exactly once."""
    key = (cfg.num_vertices, cfg.num_edges, cfg.base)
    # Single-slot per graph: one address layout is live at a time (a graph
    # is traced under one TraceConfig), and the slot is ~40 B per access —
    # an unbounded per-layout dict would pin that for every layout ever
    # used on a long-lived graph.
    cached = graph.__dict__.get("_pull_trace_addressed")
    if cached is not None and cached[0] == key:
        return cached[1]
    array_id, elem, src_vertex = _pull_body(graph)
    addr = cfg.addr(array_id, elem)
    hit = (array_id, elem, src_vertex, addr, addr >> BLOCK_BITS)
    object.__setattr__(graph, "_pull_trace_addressed", (key, hit))
    return hit


def _trace_run_batched(run: AppRun, cfg: TraceConfig) -> RunTrace:
    """One vectorized pass over the whole run.

    Push iterations are emitted from ONE concatenated frontier: a single
    cumsum assigns every active vertex its block start, then the same
    header/edge fill as the per-iteration path runs once over all
    iterations, and one address-mapping pass covers every push access.
    Dense (pull) iterations tile the cached, pre-addressed per-graph body
    — their addresses are computed once per (graph, layout) instead of
    once per iteration.  Bit-identical to the reference emitter by
    construction and by test.
    """
    g = run.graph
    offsets = g.offsets
    neighbors = g.neighbors
    frontiers = run.frontiers
    dirs = run.iteration_directions()
    iters = len(frontiers)

    pull_iters = [i for i, d in enumerate(dirs) if d == "pull"]
    push_iters = [i for i, d in enumerate(dirs) if d != "pull"]

    pull = _pull_body_addressed(g, cfg) if pull_iters else None
    pull_len = len(pull[0]) if pull is not None else 0

    # Concatenate every push frontier; per-iteration boundaries via cumsum.
    k_per = np.array([len(frontiers[i]) for i in push_iters], dtype=np.int64)
    active_all = (
        np.concatenate([frontiers[i] for i in push_iters])
        if push_iters
        else np.zeros(0, dtype=np.int64)
    ).astype(np.int64)
    deg_all = (offsets[active_all + 1] - offsets[active_all]).astype(np.int64)
    lengths_v = 3 + 2 * deg_all  # per-vertex block length (push)
    # Exclusive cumsum over all push vertices and per-iteration vertex bounds.
    cum_v = np.zeros(len(active_all) + 1, dtype=np.int64)
    np.cumsum(lengths_v, out=cum_v[1:])
    f_bounds = np.zeros(len(push_iters) + 1, dtype=np.int64)
    np.cumsum(k_per, out=f_bounds[1:])
    push_total = int(cum_v[-1])

    # Global iteration boundary offsets.
    iter_sizes = np.zeros(iters, dtype=np.int64)
    for rank, i in enumerate(push_iters):
        iter_sizes[i] = cum_v[f_bounds[rank + 1]] - cum_v[f_bounds[rank]]
    for i in pull_iters:
        iter_sizes[i] = pull_len
    iter_bounds = np.zeros(iters + 1, dtype=np.int64)
    np.cumsum(iter_sizes, out=iter_bounds[1:])
    total = int(iter_bounds[-1])

    # --- one fill pass over the concatenated push iterations -------------
    # Addresses are scattered directly per segment (base[id] + elem * esz
    # fused into each write) — same arithmetic as ``cfg.addr``, without its
    # whole-stream array-id gather passes.
    bases, esize = cfg._addr_lut
    p_aid = np.empty(push_total, dtype=np.int8)
    p_elem = np.empty(push_total, dtype=np.int64)
    p_src = np.empty(push_total, dtype=np.int64)
    p_addr = np.empty(push_total, dtype=np.int64)
    if len(active_all):
        starts = cum_v[:-1]  # each vertex's block start in the push concat
        p_aid[starts] = F_ID
        p_aid[starts + 1] = T_ID
        p_aid[starts + 2] = V_ID
        for off, aid in zip(range(3), (F_ID, T_ID, V_ID)):
            p_elem[starts + off] = active_all
            p_src[starts + off] = active_all
            p_addr[starts + off] = bases[aid] + active_all * esize[aid]

        e_total = int(deg_all.sum())
        if e_total:
            owner = np.repeat(np.arange(len(active_all), dtype=np.int64), deg_all)
            e_rank = np.arange(e_total, dtype=np.int64)
            deg_cum = np.zeros(len(active_all), dtype=np.int64)
            np.cumsum(deg_all[:-1], out=deg_cum[1:])
            j = e_rank - deg_cum[owner]  # edge index within the vertex row
            edge_global = offsets[active_all[owner]] + j
            dsts = neighbors[edge_global].astype(np.int64)
            own_src = active_all[owner]
            pos_n = starts[owner] + 3 + 2 * j
            pos_p = pos_n + 1
            p_aid[pos_n] = N_ID
            p_elem[pos_n] = edge_global
            p_src[pos_n] = own_src
            p_addr[pos_n] = bases[N_ID] + edge_global * esize[N_ID]
            p_aid[pos_p] = P_ID
            p_elem[pos_p] = dsts
            p_src[pos_p] = own_src
            p_addr[pos_p] = bases[P_ID] + dsts * esize[P_ID]
    p_block = p_addr >> BLOCK_BITS

    if not pull_iters:
        # Pure push run: the concatenation IS the whole trace — no copy.
        return RunTrace(
            array_id=p_aid,
            elem=p_elem,
            addr=p_addr,
            block=p_block,
            src_vertex=p_src,
            iter_bounds=iter_bounds,
            directions=list(dirs),
        )

    # --- mixed-direction run: assemble iteration slices ------------------
    array_id = np.empty(total, dtype=np.int8)
    elem = np.empty(total, dtype=np.int64)
    addr = np.empty(total, dtype=np.int64)
    block = np.empty(total, dtype=np.int64)
    src_vertex = np.empty(total, dtype=np.int64)
    out_arrays = (array_id, elem, src_vertex, addr, block)
    push_src = (p_aid, p_elem, p_src, p_addr, p_block)
    for i in pull_iters:
        lo = iter_bounds[i]
        for dst, src in zip(out_arrays, pull):
            dst[lo : lo + pull_len] = src
    for rank, i in enumerate(push_iters):
        lo, hi = iter_bounds[i], iter_bounds[i + 1]
        slo = cum_v[f_bounds[rank]]
        for dst, src in zip(out_arrays, push_src):
            dst[lo:hi] = src[slo : slo + (hi - lo)]
    return RunTrace(
        array_id=array_id,
        elem=elem,
        addr=addr,
        block=block,
        src_vertex=src_vertex,
        iter_bounds=iter_bounds,
        directions=list(dirs),
    )


def concat_traces(traces: List[IterationTrace], epoch_of=None):
    """Flatten to (block, array_id, epoch_id, elem) arrays for the simulator.

    ``epoch_of`` maps an iteration index to its AMC epoch (identity by
    default; per-run-protocol kernels group a whole run into one epoch).
    """
    block = np.concatenate([t.block for t in traces])
    array_id = np.concatenate([t.array_id for t in traces])
    elem = np.concatenate([t.elem for t in traces])
    epoch_of = epoch_of or (lambda i: i)
    iter_id = np.concatenate(
        [np.full(len(t), epoch_of(t.iteration), dtype=np.int32) for t in traces]
    )
    return block, array_id, iter_id, elem


def iteration_access_counts(run: AppRun, cfg: TraceConfig | None = None) -> np.ndarray:
    """Exact per-iteration access counts of ``trace_run`` without emitting.

    Push iteration ``i`` touches ``3 * |frontier|`` vertex-array slots plus
    ``2`` per outgoing edge of the frontier; a pull iteration reads the
    whole ``(frontier byte, offsets, neighbor+value)`` body: ``3n + 2m``.
    Used by :func:`iter_run_trace_chunks` to group iterations, and by the
    sharded builder to locate run boundaries without a whole-run trace.
    """
    g = run.graph
    offsets = g.offsets.astype(np.int64)
    pull_len = 3 * g.num_vertices + 2 * g.num_edges
    sizes = np.zeros(len(run.frontiers), dtype=np.int64)
    for i, (f, d) in enumerate(zip(run.frontiers, run.iteration_directions())):
        if d == "pull":
            sizes[i] = pull_len
        else:
            deg = offsets[np.asarray(f) + 1] - offsets[np.asarray(f)]
            sizes[i] = 3 * len(f) + 2 * int(deg.sum())
    return sizes


def iter_run_trace_chunks(
    run: AppRun, cfg: TraceConfig | None = None, max_accesses: int = 1 << 22
) -> Iterator[tuple]:
    """Yield ``(start_iteration, RunTrace)`` chunks covering ``run``.

    Whole iterations are grouped greedily up to ``max_accesses`` (a single
    iteration larger than the cap forms its own chunk), and each group is
    emitted through the active emitter on an iteration-sliced copy of the
    run.  Both emitters are per-iteration independent (the batched path's
    concatenated-frontier gather produces each iteration's slice from that
    iteration's frontier alone, and the pull body is a per-graph constant),
    so the concatenation of the yielded chunk streams is bit-identical to
    ``trace_run(run, cfg)`` — the whole-run trace never has to exist in
    memory at once.
    """
    g = run.graph
    cfg = cfg or TraceConfig(num_vertices=g.num_vertices, num_edges=g.num_edges)
    n_iters = len(run.frontiers)
    if n_iters == 0:
        yield 0, trace_run(run, cfg)
        return
    sizes = iteration_access_counts(run, cfg)
    dirs = run.iteration_directions()
    i0 = 0
    while i0 < n_iters:
        i1 = i0 + 1
        acc = int(sizes[i0])
        while i1 < n_iters and acc + int(sizes[i1]) <= max_accesses:
            acc += int(sizes[i1])
            i1 += 1
        sub = dataclasses.replace(
            run,
            frontiers=run.frontiers[i0:i1],
            directions=None if run.directions is None else dirs[i0:i1],
            num_iters=i1 - i0,
        )
        yield i0, trace_run(sub, cfg)
        i0 = i1
