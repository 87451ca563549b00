"""Workload driver: app -> trace -> composite simulation -> metrics.

One :class:`WorkloadTrace` per (kernel, dataset) bundles the full access
trace, the shared demand profile, and the composite *baseline run* (demand +
next-line, per the paper's Table VI L2). Prefetchers consume it through
``amc_iteration_views()`` (AMC) or the raw substream accessors (baselines).

Construction is declared by a :class:`WorkloadSpec` — kernel, dataset,
hierarchy, seed, and the AMC programming-model parameters (Table V element
sizes) in one frozen value, validated up front.  ``WorkloadSpec.build()``
(or the ``build_workload`` convenience wrapper) produces the trace with the
:class:`AMCSession` wired exactly as Algorithm 1 does.

Every kernel-protocol decision — weighted input, the §VI two-run evolving
protocol, the shared traversal root, the AMC epoch structure, traversal
direction — dispatches on the kernel's declarative
:class:`~repro_torch.apps.registry.KernelSpec`; there are no kernel-name string
special-cases here.  Trace emission is the whole-run batched emitter
(:func:`repro_torch.apps.trace.trace_run`), bit-identical to the per-iteration
reference oracle.

Scoring lives in :mod:`repro_torch.core.experiment`.

PyTorch port: the app and the cache simulation run on the device the
caller names (``device=``, default the CUDA card); trace emission and the
prefetchers are host numpy, as in the JAX package.  Only single-run
kernels are ported so far; a two-run kernel raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.apps import get_kernel, has_kernel, kernel_traits, list_kernels
from repro_torch.apps.ligra import AppRun
from repro_torch.apps.trace import T_ID, TraceConfig, trace_run
from repro_torch.core.amc.api import AMCSession
from repro_torch.core.amc.prefetcher import IterationView
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import DATASETS, make_dataset
from repro_torch.memsim import (
    SCALED,
    DemandProfile,
    HierarchyConfig,
    simulate_demand,
    simulate_with_prefetch,
)
from repro_torch.memsim.config import BLOCK_BITS
from repro_torch.memsim.hierarchy import PrefetchOutcome

@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Declarative description of one (kernel, dataset) workload cell.

    Folds the AMC programming-model configuration (paper Table V: the
    target/frontier element sizes behind ``AddrTBase``/``AddrFBase``) into
    the workload declaration, so Algorithm-1 wiring is validated here once
    instead of being hand-sequenced at every call site.  Hashable — used as
    the workload-cache key by :class:`repro_torch.core.experiment.Experiment`.
    """

    kernel: str
    dataset: str
    hierarchy: HierarchyConfig = SCALED
    seed: int = 0
    target_elem_size: int = 8  # vertex property width (AddrTBase)
    frontier_elem_size: int = 1  # frontier flag width (AddrFBase)

    def __post_init__(self):
        if self.target_elem_size < 1 or self.frontier_elem_size < 1:
            raise ValueError("element sizes must be >= 1 byte")
        if self.target_elem_size % self.frontier_elem_size:
            raise ValueError(
                f"target_elem_size ({self.target_elem_size}) must be an "
                f"integer multiple of frontier_elem_size "
                f"({self.frontier_elem_size}): the §V-C2 address calculation "
                "scales by their integer ratio and would silently truncate"
            )

    def validate_names(self) -> None:
        """Check kernel/dataset against the registries. Called before the
        app is run from names; skipped when caller-supplied ``runs`` make
        the names purely descriptive."""
        if not has_kernel(self.kernel):
            raise ValueError(
                f"unknown kernel {self.kernel!r}; available: {sorted(list_kernels())}"
            )
        if self.dataset not in DATASETS:
            raise ValueError(
                f"unknown dataset {self.dataset!r}; available: {sorted(DATASETS)}"
            )

    def build(
        self, runs: Optional[List[AppRun]] = None, device: DeviceLike = None
    ) -> "WorkloadTrace":
        if runs is None:
            self.validate_names()
        return _build_workload(self, runs, device=device)


@dataclasses.dataclass
class WorkloadTrace:
    spec: WorkloadSpec
    kernel: str
    dataset: str
    cfg_trace: TraceConfig
    block: np.ndarray
    array_id: np.ndarray
    epoch_id: np.ndarray  # AMC epoch per access
    iter_id: np.ndarray  # global iteration per access
    elem: np.ndarray
    iter_epochs: List[Tuple[int, int]]  # per global iteration: (epoch, within)
    profile: DemandProfile
    nl_blocks: np.ndarray
    nl_pos: np.ndarray
    nl_outcome: PrefetchOutcome  # the baseline run (demand + next-line)
    eval_from_pos: int
    session: AMCSession
    # Host-clock seconds of the build stages (app, trace_emit, demand_sim).
    # Each stage ends by copying its device results to the host, so the
    # clock covers the device work.
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        """Where the workload's cache passes ran; scoring runs there too."""
        return self.profile.device

    @property
    def input_bytes(self) -> int:
        return self.cfg_trace.input_bytes

    @property
    def num_accesses(self) -> int:
        return len(self.block)

    # ---- composite-baseline L2 miss stream (recording ground truth) ----

    def baseline_miss_stream(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        sel = ~self.nl_outcome.demand_l2_hit
        pos = self.profile.l2_pos[sel]
        blocks = self.profile.l2_blocks[sel]
        iters = self.iter_id[pos]
        return pos, blocks, iters

    def amc_iteration_views(self):
        """Yield (IterationView, epoch) in iteration order for AMC."""
        t_base, t_size = self.cfg_trace.target_range
        t_lo, t_hi = t_base >> BLOCK_BITS, (t_base + t_size) >> BLOCK_BITS
        mpos, mblocks, miters = self.baseline_miss_stream()
        not_target = ~((mblocks >= t_lo) & (mblocks <= t_hi))
        mpos, mblocks, miters = (
            mpos[not_target],
            mblocks[not_target],
            miters[not_target],
        )
        tmask = self.array_id == T_ID
        tpos_all = np.flatnonzero(tmask)
        titer = self.iter_id[tpos_all]
        tvid = self.elem[tpos_all]
        # Both streams are iteration-sorted (positions ascend and iter_id is
        # nondecreasing along the trace), so the per-iteration views are
        # contiguous slices: two searchsorted calls replace the
        # O(iterations x N) per-iteration boolean masks.
        edges = np.arange(len(self.iter_epochs) + 1)
        t_bounds = np.searchsorted(titer, edges)
        m_bounds = np.searchsorted(miters, edges)
        views = []
        for it, (epoch, within) in enumerate(self.iter_epochs):
            t0, t1 = t_bounds[it], t_bounds[it + 1]
            m0, m1 = m_bounds[it], m_bounds[it + 1]
            views.append(
                (
                    IterationView(
                        iteration=it,
                        within_epoch=within,
                        target_pos=tpos_all[t0:t1],
                        target_vid=tvid[t0:t1],
                        miss_pos=mpos[m0:m1],
                        miss_blocks=mblocks[m0:m1],
                    ),
                    epoch,
                )
            )
        return views

    # ---- L2 access substream view for the baseline prefetchers ----

    def l2_stream(self):
        """(pos, blocks, array_id, epoch) of L2 accesses (= L1 misses)."""
        p = self.profile
        return p.l2_pos, p.l2_blocks, self.array_id[p.l2_pos], self.epoch_id[p.l2_pos]


def _nextline_stream(profile: DemandProfile):
    """Degree-1 next-line at L2, trained on L2 accesses; consecutive
    same-line triggers filtered (standard)."""
    b = profile.l2_blocks
    p = profile.l2_pos
    if len(b) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    keep = np.ones(len(b), dtype=bool)
    keep[1:] = b[1:] != b[:-1]
    return b[keep] + 1, p[keep]


def _run_app(kernel: str, dataset: str, device: torch.device) -> List[AppRun]:
    """Run the kernel per its spec's protocol; returns the run list."""
    ks = get_kernel(kernel)
    if ks.two_run:
        raise NotImplementedError(
            f"kernel {kernel!r} uses the two-run evolving protocol, which "
            "the port does not have yet (graphs/evolve.py and the bfs/cc/bf "
            "apps are still to be ported)"
        )
    g = make_dataset(dataset, weighted=ks.weighted)
    return [ks.run(g, device=device)]


def build_workload(
    kernel,
    dataset: Optional[str] = None,
    hierarchy: HierarchyConfig = SCALED,
    seed: int = 0,
    runs: Optional[List[AppRun]] = None,
    *,
    target_elem_size: int = 8,
    frontier_elem_size: int = 1,
    device: DeviceLike = None,
) -> WorkloadTrace:
    """Build a workload trace. Accepts a :class:`WorkloadSpec` or the legacy
    positional ``(kernel, dataset, ...)`` form.  ``device`` (default the
    CUDA card) is where the app and the cache simulation run."""
    if isinstance(kernel, WorkloadSpec):
        if (
            dataset is not None
            or hierarchy is not SCALED
            or seed != 0
            or target_elem_size != 8
            or frontier_elem_size != 1
        ):
            raise ValueError(
                "build_workload(spec) takes all configuration from the "
                "WorkloadSpec; don't pass dataset/hierarchy/seed/elem-size "
                "arguments alongside it"
            )
        return kernel.build(runs=runs, device=device)
    spec = WorkloadSpec(
        kernel=kernel,
        dataset=dataset,
        hierarchy=hierarchy,
        seed=seed,
        target_elem_size=target_elem_size,
        frontier_elem_size=frontier_elem_size,
    )
    return spec.build(runs=runs, device=device)


def make_session(spec: WorkloadSpec, cfg_trace: TraceConfig) -> AMCSession:
    """Programming-model session, configured exactly as Algorithm 1 does —
    element sizes come from the declarative spec (Table V wiring).  Also
    used by the workload artifact cache to reconstruct loaded traces."""
    sess = AMCSession()
    sess.init(asid=0)
    t_base, t_size = cfg_trace.target_range
    f_base, f_size = cfg_trace.frontier_range
    sess.addr_t_base(t_base, t_size, elem_size=spec.target_elem_size)
    sess.addr_f_base(f_base, f_size, elem_size=spec.frontier_elem_size)
    return sess


def _build_workload(
    spec: WorkloadSpec,
    runs: Optional[List[AppRun]],
    cfg_trace: Optional[TraceConfig] = None,
    epoch_mode: Optional[str] = None,
    device: DeviceLike = None,
) -> WorkloadTrace:
    """Build the trace for ``spec``.

    ``cfg_trace`` overrides the address layout — the streaming protocol
    (``repro.stream.protocol`` in the JAX package) lays every epoch of a
    stream out in one shared space so cross-epoch correlations stay valid.  ``epoch_mode``
    selects the AMC-epoch structure: ``None`` keeps the kernel spec's
    declared ``epoch_protocol`` (per-iteration epochs, or one epoch per
    run for the two-run kernels); ``"single"`` puts the whole trace in one
    epoch with the iteration index as the within-epoch key — one *stream
    epoch*, replayed against the previous epoch's recordings by the table
    lifecycle.
    """
    dev = resolve_device(device)
    kernel, dataset, hierarchy = spec.kernel, spec.dataset, spec.hierarchy
    # Ad-hoc kernel names with caller-supplied runs get the default
    # per-iteration traits; registered kernels dispatch on their spec.
    ks = kernel_traits(kernel)
    t0 = time.perf_counter()
    runs = runs if runs is not None else _run_app(kernel, dataset, dev)
    t_app = time.perf_counter()
    if cfg_trace is None:
        # Shared layout across runs (same id space - evolve.py keeps it).
        g = runs[0].graph
        cfg_trace = TraceConfig(
            num_vertices=g.num_vertices,
            num_edges=max(r.graph.num_edges for r in runs),
        )

    run_traces = []
    iter_epochs: List[Tuple[int, int]] = []
    git = 0
    run_start_iter = []
    for run_idx, run in enumerate(runs):
        rt = trace_run(run, cfg_trace)
        run_start_iter.append(git)
        for k in range(rt.num_iters):
            if epoch_mode == "single":
                iter_epochs.append((0, git))
            elif ks.two_run:
                iter_epochs.append((run_idx, k))
            else:
                iter_epochs.append((git, 0))
            git += 1
        run_traces.append(rt)

    if len(run_traces) == 1:  # single-run kernels: no concat copy
        rt = run_traces[0]
        block, array_id, elem = rt.block, rt.array_id, rt.elem
    else:
        block = np.concatenate([rt.block for rt in run_traces])
        array_id = np.concatenate([rt.array_id for rt in run_traces])
        elem = np.concatenate([rt.elem for rt in run_traces])
    iter_id = np.concatenate(
        [
            np.repeat(
                np.arange(s, s + rt.num_iters, dtype=np.int32),
                rt.iter_sizes,
            )
            for s, rt in zip(run_start_iter, run_traces)
        ]
    )
    epoch_id = np.asarray(
        [iter_epochs[i][0] for i in range(git)], dtype=np.int32
    )[iter_id]
    t_trace = time.perf_counter()

    profile = simulate_demand(block, iter_id, hierarchy, device=dev)
    nl_blocks, nl_pos = _nextline_stream(profile)
    nl_outcome = simulate_with_prefetch(
        profile, nl_blocks, nl_pos, pf_issuer=np.zeros(len(nl_blocks), np.int8)
    )
    t_sim = time.perf_counter()

    eval_from = 0
    if ks.two_run and len(runs) > 1:
        # Evaluate on the second (post-change) run only.
        second_first_iter = run_start_iter[1]
        eval_from = int(np.searchsorted(iter_id, second_first_iter))

    sess = make_session(spec, cfg_trace)

    return WorkloadTrace(
        spec=spec,
        kernel=kernel,
        dataset=dataset,
        cfg_trace=cfg_trace,
        block=block,
        array_id=array_id,
        epoch_id=epoch_id,
        iter_id=iter_id,
        elem=elem,
        iter_epochs=iter_epochs,
        profile=profile,
        nl_blocks=nl_blocks,
        nl_pos=nl_pos,
        nl_outcome=nl_outcome,
        eval_from_pos=eval_from,
        session=sess,
        stage_seconds=dict(
            app=t_app - t0, trace_emit=t_trace - t_app, demand_sim=t_sim - t_trace
        ),
    )
