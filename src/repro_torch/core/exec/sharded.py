"""Paper-scale sharded traces with bounded-memory streaming scoring
(PyTorch port of ``repro.core.exec.sharded``).

A :class:`ShardedSpec` wraps a plain :class:`~repro_torch.core.driver.WorkloadSpec`
and replaces the monolithic :class:`~repro_torch.core.driver.WorkloadTrace` with
fixed-size trace shards in the content-addressed artifact cache (shard ``i``
is keyed on ``sha256(key(spec) + "#shard" + i)``; a JSON manifest written
*last* commits the build).  Scoring then streams the shards through the
carried-state simulators so peak memory is O(shard) in the trace length:

- **Build** (:func:`ensure_shards`): the app runs as usual (the graph is
  resident during emission), but the trace is emitted iteration-group by
  iteration-group (:func:`repro_torch.apps.trace.iter_run_trace_chunks`) and
  re-sliced into exact ``shard_accesses``-sized files — the whole-run
  access stream never exists in memory.
- **Phase 1** (per workload): one sweep over the shards with the carried
  :class:`~repro_torch.memsim.hierarchy.DemandState`, spilling the L2 substream,
  the windowed miss-position streams (for MLP), the baseline-composite
  miss stream and the target-array accesses (for AMC's training views),
  while a :class:`~repro_torch.memsim.streaming.CompositeRunScorer` scores the
  demand + next-line baseline run.
- **Phase 2** (per prefetcher): replay the spilled L2 substream chunk by
  chunk, generate/slice the prefetcher's stream per chunk, and score a
  second :class:`CompositeRunScorer`; the closed-form metrics arithmetic
  mirrors :func:`repro_torch.memsim.metrics.evaluate` term for term.

Working state is proportional to the number of *distinct* blocks touched
(cache tags, the classify carry, the per-block last-miss table) — the
graph footprint — and to one shard, never to the trace length.  The one
documented exception is the generated prefetch stream of table-driven
prefetchers (AMC's issue stream is materialized once, then sliced).

Sharded scoring is bit-identical to the unsharded path and to the JAX
package's ``score_sharded`` — every metric field, including AMC's ``info``
dict — on all three cache engines (``tests/test_torch_sharded.py``).

The device work runs where the caller asks (``device=``, default the
CUDA card): the app of the build, phase 1's carried demand passes (kernel
K2 under the ``fused`` engine, a carried state per shard) and every
scorer's L2/LLC passes (kernel K1 from a carried state per shard and
level).  The carried cache states stay on the device; emission, the shard
files, the spills and the counts stay on the host.  Spans (with a tracer
active): ``ensure_shards`` (the build), ``sharded_sweep`` (phase 1, a
``shard_demand`` child per shard) and ``sharded_replay`` (phase 2, one per
prefetcher, its stream included).

Streaming adapters exist for ``nextline2`` (O(1) carry) and the ``amc``
family (training views streamed from spills).  Other prefetchers consume
whole-trace substreams by contract and raise :class:`ShardedScoringError`.
"""
from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path
from typing import ClassVar, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.apps.registry import kernel_traits
from repro_torch.apps.trace import T_ID, TraceConfig, iter_run_trace_chunks
from repro_torch.core.amc.prefetcher import IterationView
from repro_torch.core.driver import WorkloadSpec, _run_app
from repro_torch.core.exec.artifacts import ArtifactCache
from repro_torch.core.exec.timers import stage
from repro_torch.core.obs import spans as obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.memsim.config import BLOCK_BITS, HierarchyConfig
from repro_torch.memsim.hierarchy import demand_init_state, simulate_demand
from repro_torch.memsim.metrics import PrefetchMetrics
from repro_torch.memsim.streaming import (
    BlockPosTable,
    CompositeRunScorer,
    SpillFile,
    iter_grouped,
    spilled_mlp,
)
from repro_torch.memsim.timing import TimingModel, avg_miss_cost

DEFAULT_SHARD_ACCESSES = 1 << 22  # 4M accesses/shard (~100MB resident peak)


class ShardedScoringError(RuntimeError):
    """A prefetcher without a streaming adapter met a ShardedSpec."""


# A long run feeds hundreds of chunks of drifting sizes; without a
# periodic release, freed-but-retained allocator pages (the host's malloc
# arenas, the CUDA caching allocator's blocks) creep upward and break the
# flat-memory contract this module exists to provide.
_RELEASE_EVERY = 16


def _release_memory(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # non-glibc: caches alone are freed
        pass


@dataclasses.dataclass(frozen=True)
class ShardedSpec:
    """A workload cell scored through the sharded streaming path.

    Wraps the plain spec (which fully determines the trace) plus the shard
    size.  Duck-typed via ``is_sharded`` the same way stream/serve specs
    are — :class:`~repro_torch.core.experiment.Experiment` and the grid
    scheduler branch on the flag, and the artifact cache keys shards on
    the full (base + shard_accesses) identity.
    """

    base: WorkloadSpec
    shard_accesses: int = DEFAULT_SHARD_ACCESSES

    is_sharded: ClassVar[bool] = True

    def __post_init__(self):
        if self.shard_accesses < 1:
            raise ValueError("shard_accesses must be >= 1")

    @property
    def kernel(self) -> str:
        return self.base.kernel

    @property
    def dataset(self) -> str:
        return self.base.dataset

    @property
    def seed(self) -> int:
        return self.base.seed

    @property
    def hierarchy(self) -> HierarchyConfig:
        return self.base.hierarchy

    def validate_names(self) -> None:
        self.base.validate_names()


class _ShardWriter:
    """Re-slices pushed trace chunks into exact fixed-size shard files."""

    def __init__(self, cache: ArtifactCache, spec: ShardedSpec):
        self.cache = cache
        self.spec = spec
        self.cap = spec.shard_accesses
        self.buf: List[Tuple[np.ndarray, ...]] = []
        self.buffered = 0
        self.total = 0
        self.sizes: List[int] = []

    def push(self, block, array_id, iter_id, elem) -> None:
        self.buf.append((block, array_id, iter_id, elem))
        self.buffered += len(block)
        self.total += len(block)
        while self.buffered >= self.cap:
            self._flush(self.cap)

    def _flush(self, n: int) -> None:
        cols = [np.concatenate([part[j] for part in self.buf]) for j in range(4)]
        self.cache.save_shard(
            self.spec,
            len(self.sizes),
            dict(
                block=cols[0][:n],
                array_id=cols[1][:n],
                iter_id=cols[2][:n],
                elem=cols[3][:n],
            ),
        )
        self.sizes.append(n)
        self.buf = [tuple(c[n:] for c in cols)]
        self.buffered -= n

    def finish(self) -> List[int]:
        if self.buffered:
            self._flush(self.buffered)
        return self.sizes


def ensure_shards(
    spec: ShardedSpec, cache: ArtifactCache, device: DeviceLike = None
) -> dict:
    """Build (or load) the shard store for ``spec``; returns the manifest.

    Mirrors ``_build_workload``'s protocol decisions exactly — epoch
    structure, shared address layout across runs, the two-run evaluation
    window — but the window start is computed from per-run access offsets
    (``searchsorted(iter_id, second_run_first_iter)`` equals run 1's total
    length because ``iter_id`` is nondecreasing), so no whole-trace array
    is ever needed.  The app runs on ``device`` (default the CUDA card);
    emission and the shard files stay on the host.
    """
    if cache.has(spec):
        manifest = cache.load_manifest(spec)
        if manifest is not None:
            return manifest
    dev = resolve_device(device)
    spec.validate_names()
    ks = kernel_traits(spec.kernel)
    with obs.span(
        "ensure_shards",
        kernel=spec.kernel,
        dataset=spec.dataset,
        shard_accesses=spec.shard_accesses,
    ), stage("trace_gen"):
        runs = _run_app(spec.kernel, spec.dataset, spec.seed, dev)
        g = runs[0].graph
        cfg_trace = TraceConfig(
            num_vertices=g.num_vertices,
            num_edges=max(r.graph.num_edges for r in runs),
        )
        iter_epochs: List[Tuple[int, int]] = []
        run_start_iter: List[int] = []
        git = 0
        for run_idx, run in enumerate(runs):
            run_start_iter.append(git)
            for k in range(len(run.frontiers)):
                iter_epochs.append((run_idx, k) if ks.two_run else (git, 0))
                git += 1
        with stage("trace_emit"):
            writer = _ShardWriter(cache, spec)
            run_access_start: List[int] = []
            for s, run in zip(run_start_iter, runs):
                run_access_start.append(writer.total)
                for i0, rt in iter_run_trace_chunks(
                    run, cfg_trace, max_accesses=spec.shard_accesses
                ):
                    it_id = np.repeat(
                        np.arange(s + i0, s + i0 + rt.num_iters, dtype=np.int32),
                        rt.iter_sizes,
                    )
                    writer.push(rt.block, rt.array_id, it_id, rt.elem)
            shard_sizes = writer.finish()
    eval_from = 0
    if ks.two_run and len(runs) > 1:
        eval_from = int(run_access_start[1])
    manifest = {
        "kernel": spec.kernel,
        "dataset": spec.dataset,
        "seed": spec.seed,
        "num_accesses": int(writer.total),
        "shard_accesses": int(spec.shard_accesses),
        "shard_sizes": [int(x) for x in shard_sizes],
        "iter_epochs": [[int(a), int(b)] for a, b in iter_epochs],
        "eval_from_pos": eval_from,
        "num_vertices": int(cfg_trace.num_vertices),
        "num_edges": int(cfg_trace.num_edges),
        "base": int(cfg_trace.base),
    }
    cache.save_manifest(spec, manifest)
    return manifest


def _check_adapter(name: str) -> None:
    """Only ``nextline2`` and the ``amc`` family have streaming adapters."""
    if name != "nextline2" and not name.startswith("amc"):
        raise ShardedScoringError(
            f"prefetcher {name!r} has no streaming adapter "
            "(available: nextline2, amc*); score it through the "
            "unsharded WorkloadSpec path"
        )


def _nextline_chunk(b: np.ndarray, p: np.ndarray, carry: Optional[int]):
    """Chunked ``_nextline_stream``: consecutive-duplicate filtering with
    the previous chunk's last L2 block carried across the seam."""
    if len(b) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), carry
    keep = np.ones(len(b), dtype=bool)
    keep[1:] = b[1:] != b[:-1]
    if carry is not None:
        keep[0] = b[0] != carry
    return b[keep] + 1, p[keep], int(b[-1])


class _ShardedWorkloadView:
    """The two-attribute surface ``AMCPrefetcher.generate`` consumes
    (``input_bytes`` + ``amc_iteration_views()``), with the per-iteration
    training views streamed from phase-1 spills instead of whole-trace
    arrays.  View contents are bit-identical to
    ``WorkloadTrace.amc_iteration_views()`` (same dtypes, same
    target-range filter, empty iterations included)."""

    def __init__(
        self,
        cfg_trace: TraceConfig,
        iter_epochs: List[Tuple[int, int]],
        target_spill: SpillFile,  # (pos, vid, iter)
        miss_spill: SpillFile,  # (pos, block, iter) baseline-composite misses
    ):
        self.cfg_trace = cfg_trace
        self.input_bytes = cfg_trace.input_bytes
        self._iter_epochs = iter_epochs
        self._target = target_spill
        self._miss = miss_spill

    def amc_iteration_views(self):
        t_base, t_size = self.cfg_trace.target_range
        t_lo, t_hi = t_base >> BLOCK_BITS, (t_base + t_size) >> BLOCK_BITS
        n = len(self._iter_epochs)
        tgt_groups = iter_grouped(self._target, 2, n)
        miss_groups = iter_grouped(self._miss, 2, n)
        for (it, (tp, tv, _ti)), (_it, (mp, mb, _mi)) in zip(
            tgt_groups, miss_groups
        ):
            not_target = ~((mb >= t_lo) & (mb <= t_hi))
            epoch, within = self._iter_epochs[it]
            yield (
                IterationView(
                    iteration=it,
                    within_epoch=within,
                    target_pos=tp,
                    target_vid=tv,
                    miss_pos=mp[not_target],
                    miss_blocks=mb[not_target],
                ),
                epoch,
            )


def iter_shard_arrays(
    spec: ShardedSpec, cache: ArtifactCache, manifest: dict
) -> Iterator[dict]:
    """The shard files of ``manifest``, loaded one at a time, in order."""
    for k in range(len(manifest["shard_sizes"])):
        yield cache.load_shard(spec, k)


def score_sharded(
    spec: ShardedSpec,
    prefetchers: List[Tuple[str, object]],
    cache: Optional[ArtifactCache] = None,
    tm: TimingModel = TimingModel(),
    device: DeviceLike = None,
) -> List[Tuple[str, PrefetchMetrics]]:
    """Score ``prefetchers`` on ``spec`` with O(shard) peak memory, the
    cache passes on ``device`` (default the CUDA card).

    Returns ``(name, metrics)`` pairs in input order, bit-identical to the
    unsharded ``score_prefetcher`` results for the same base spec.  A
    prefetcher without a streaming adapter raises
    :class:`ShardedScoringError` before any shard is built or swept.
    """
    dev = resolve_device(device)
    for name, _ in prefetchers:
        _check_adapter(name)
    cache = cache if cache is not None else ArtifactCache()
    manifest = ensure_shards(spec, cache, dev)
    cfg = spec.hierarchy
    t0 = int(manifest["eval_from_pos"])
    num_accesses = int(manifest["num_accesses"])
    iter_epochs = [(int(a), int(b)) for a, b in manifest["iter_epochs"]]
    bounds = np.zeros(len(manifest["shard_sizes"]) + 1, dtype=np.int64)
    np.cumsum(np.asarray(manifest["shard_sizes"], dtype=np.int64), out=bounds[1:])
    cfg_trace = TraceConfig(
        num_vertices=manifest["num_vertices"],
        num_edges=manifest["num_edges"],
        base=manifest["base"],
    )
    results: List[Tuple[str, PrefetchMetrics]] = []
    with stage("score"), tempfile.TemporaryDirectory(
        prefix="repro-torch-sharded-"
    ) as tmp:
        td = Path(tmp)
        # ---- phase 1: one sweep building the baseline + all spills
        l2_spill = SpillFile(td / "l2sub.i64", cols=3)  # pos, block, iter
        l2_rows: List[int] = []
        mp_spill = SpillFile(td / "base.mp.i64", cols=1)  # windowed, demand-only
        dp_spill = SpillFile(td / "base.dp.i64", cols=1)
        bl_miss = SpillFile(td / "blmiss.i64", cols=3)  # pos, block, iter
        tgt_spill = SpillFile(td / "target.i64", cols=3)  # pos, vid, iter
        base_sc = CompositeRunScorer(
            cfg, t0, td, "base", sel_issuer=None, miss_sink=bl_miss, device=dev
        )
        no_future = BlockPosTable()
        dstate = demand_init_state(cfg, dev)
        nl_carry: Optional[int] = None
        l1w = l2w = dramw = 0
        with obs.span("sharded_sweep", shards=len(manifest["shard_sizes"])):
            for k, arrays in enumerate(iter_shard_arrays(spec, cache, manifest)):
                blocks = arrays["block"]
                iters = arrays["iter_id"]
                with obs.span("shard_demand", shard=k, accesses=len(blocks)):
                    profile, dstate = simulate_demand(
                        blocks, iters, cfg, state=dstate, return_state=True,
                        device=dev,
                    )
                obs.inc("sharded.shards_swept")
                d_pos = profile.l2_pos  # global positions (carry offsets them)
                d_blocks = profile.l2_blocks
                d_iter = profile.l2_iter.astype(np.int64)
                l2_spill.append(d_pos, d_blocks, d_iter)
                l2_rows.append(len(d_pos))
                l1w += int((d_pos >= t0).sum())
                dmiss = ~profile.l2_hit
                mp = d_pos[dmiss]
                l2w += int((mp >= t0).sum())
                mp_spill.append(mp[mp >= t0])
                dp = mp[~profile.llc_hit]
                dramw += int((dp >= t0).sum())
                dp_spill.append(dp[dp >= t0])
                no_future.update(d_blocks[dmiss], mp)
                nl_b, nl_p, nl_carry = _nextline_chunk(d_blocks, d_pos, nl_carry)
                base_sc.feed(
                    d_pos,
                    d_blocks,
                    nl_b,
                    nl_p,
                    np.zeros(len(nl_b), np.int8),
                    d_iter=d_iter,
                )
                tmask = arrays["array_id"] == T_ID
                tgt_spill.append(
                    np.flatnonzero(tmask).astype(np.int64) + bounds[k],
                    arrays["elem"][tmask].astype(np.int64),
                    iters[tmask].astype(np.int64),
                )
                if (k + 1) % _RELEASE_EVERY == 0:
                    _release_memory(dev)
        base = dict(
            accesses=num_accesses - t0,
            l1_miss=l1w,
            l2_miss=l2w,
            llc_miss=dramw,
            dram=dramw,
        )
        late_cost = avg_miss_cost(
            l2_misses=l2w,
            dram_misses=dramw,
            l2_miss_pos=np.zeros(0, np.int64),
            dram_pos=np.zeros(0, np.int64),
            cfg=cfg,
            tm=tm,
            mlp_llc=spilled_mlp(mp_spill, tm.mlp_window, tm.mlp_cap_llc),
            mlp_dram=spilled_mlp(dp_spill, tm.mlp_window, tm.mlp_cap_dram),
        )
        base_cycles, base_counts = base_sc.finalize(
            base, base["dram"], late_cost, 0, tm
        )
        mp_spill.close()
        dp_spill.close()

        # ---- phase 2: replay the L2 substream once per prefetcher
        for pf_idx, (name, gen) in enumerate(prefetchers):
            with obs.span("sharded_replay", prefetcher=name):
                obs.inc("sharded.replays")
                x_pos = x_blocks = None
                meta_bytes = 0
                info: dict = {}
                if name == "nextline2":
                    pass  # chunk stream derived from the next-line regen below
                else:  # the amc family (_check_adapter let nothing else in)
                    shim = _ShardedWorkloadView(
                        cfg_trace, iter_epochs, tgt_spill, bl_miss
                    )
                    stream = gen(shim)
                    meta_bytes = stream.metadata_bytes
                    info = stream.info
                    # Global stable position sort once, so per-chunk slices
                    # reproduce the whole-trace merge's equal-position order.
                    xo = np.argsort(stream.pos, kind="stable")
                    x_pos = stream.pos[xo].astype(np.int64)
                    x_blocks = stream.blocks[xo].astype(np.int64)
                sc = CompositeRunScorer(
                    cfg, t0, td, f"run{pf_idx}", sel_issuer=1, no_future=no_future,
                    device=dev,
                )
                nl_carry = None
                for k, (d_pos, d_blocks, _di) in enumerate(l2_spill.groups(l2_rows)):
                    nl_b, nl_p, nl_carry = _nextline_chunk(d_blocks, d_pos, nl_carry)
                    if x_pos is None:  # nextline2: same triggers, +2 lines
                        cx_b, cx_p = nl_b + 1, nl_p
                    else:
                        lo, hi = np.searchsorted(x_pos, [bounds[k], bounds[k + 1]])
                        cx_b, cx_p = x_blocks[lo:hi], x_pos[lo:hi]
                    sc.feed(
                        d_pos,
                        d_blocks,
                        np.concatenate([nl_b, cx_b]),
                        np.concatenate([nl_p, cx_p]),
                        np.concatenate(
                            [
                                np.zeros(len(nl_b), np.int8),
                                np.ones(len(cx_b), np.int8),
                            ]
                        ),
                    )
                    if (k + 1) % _RELEASE_EVERY == 0:
                        _release_memory(dev)
                meta_dram = meta_bytes >> BLOCK_BITS
                run_cycles, run_counts = sc.finalize(
                    base, base["dram"], late_cost, meta_dram, tm
                )
            results.append(
                (
                    name,
                    _metrics(
                        name,
                        base,
                        base_cycles,
                        base_counts,
                        run_cycles,
                        run_counts,
                        sc,
                        meta_dram,
                        info,
                    ),
                )
            )
        for sp in (l2_spill, bl_miss, tgt_spill):
            sp.close()
    return results


def _metrics(
    name: str,
    base: dict,
    base_cycles: float,
    base_counts: dict,
    run_cycles: float,
    run_counts: dict,
    sc: CompositeRunScorer,
    meta_dram: int,
    info: dict,
) -> PrefetchMetrics:
    """``metrics.evaluate``'s closing arithmetic, from streamed counts."""
    baseline_misses = base_counts["l2_misses"]
    dram_b = base_counts["dram_total"]
    dram_r = run_counts["dram_total"]
    extra = (dram_r - dram_b) / max(dram_b, 1)
    meta = meta_dram / max(dram_b, 1)
    issued_eff = sc.issued - sc.redundant
    return PrefetchMetrics(
        name=name,
        accuracy=sc.useful / max(issued_eff, 1),
        coverage=sc.useful / max(baseline_misses, 1),
        speedup=base_cycles / max(run_cycles, 1e-9),
        ipc_baseline=base["accesses"] / max(base_cycles, 1e-9),
        ipc_prefetch=base["accesses"] / max(run_cycles, 1e-9),
        issued=sc.issued,
        useful=sc.useful,
        late=sc.late_sel,
        evicted_early=sc.early,
        overpredicted=sc.overpred,
        redundant=sc.redundant,
        baseline_l2_misses=baseline_misses,
        extra_traffic=float(extra),
        metadata_traffic=float(meta),
        dram_demand=run_counts["dram_demand"],
        dram_total=dram_r,
        info=info,
    )


__all__ = [
    "DEFAULT_SHARD_ACCESSES",
    "ShardedScoringError",
    "ShardedSpec",
    "ensure_shards",
    "score_sharded",
]
