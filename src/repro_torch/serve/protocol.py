"""Serving protocol: K concurrent query traces on the Experiment engine
(ported from ``repro.serve.protocol``).

A :class:`ServeSpec` declares one multi-tenant serving scenario — K
:class:`TenantSpec` query workloads (mixed kernels x roots x datasets), an
interleave policy, and the AMC ``TableMode`` axis — and plugs into the
existing machinery like a :class:`~repro_torch.core.driver.WorkloadSpec`:

- **Per-tenant traces, built once, cached.**  Each tenant is an ordinary
  :class:`WorkloadSpec` (content-addressable), so the
  :class:`~repro_torch.core.exec.artifacts.ArtifactCache` persists tenant traces
  and the parallel scheduler materializes them across the pool.  Scoring
  happens in the parent — serial and ``workers=N`` results are
  byte-identical, same contract as the stream protocol.
- **Interleaved shared LLC.**  The deterministic interleaver
  (:mod:`repro_torch.serve.interleave`) merges the K traces into one global
  order; private L1/L2 run per tenant on their own substreams and the LLC
  is re-simulated once on the interleaved miss stream
  (:mod:`repro_torch.memsim.shared_llc`).  The *baseline* composite runs share
  the LLC too, so speedups compare contended runs against contended
  baselines.
- **TableMode axis.**  AMC-family prefetchers score under ``per_tenant``
  (one private table store each — the provisioned-isolation upper bound)
  and ``shared`` (one store for everyone —
  :func:`repro_torch.serve.tables.shared_table_streams`, the paper's
  correlation-aliasing failure mode at serving scale).  Stateless
  baselines score once with ``table_mode=None``.
- **Contention report.**  Every cell's ``metrics.info["serve"]`` carries
  per-tenant contention counters (LLC hits lost to other tenants,
  shared-table thrash/aliasing); :func:`contention_payload` aggregates
  them into the JAX package's ``serve-contention`` JSON schema.

K=1 is the anchor: one tenant, identity interleave, zero-offset LLC
namespace, no foreign table owner — every row is byte-identical to the
single-tenant :func:`~repro_torch.core.experiment.score_prefetcher` path
(asserted in ``tests/test_torch_serve.py``).

PyTorch port: the interleave, the merge keys and the shared-table walk are
host numpy (int64 keys, float64 virtual times), as in the JAX package;
every cache pass — each tenant's private L2/LLC re-simulation and the
shared LLC over all K tenants — runs on the device the tenants' traces
were built on (kernel K1 on the card).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.driver import WorkloadSpec, WorkloadTrace
from repro_torch.core.exec.timers import stage
from repro_torch.core.obs import spans as obs
from repro_torch.device import DeviceLike
from repro_torch.memsim import (
    SCALED,
    HierarchyConfig,
    PrefetchMetrics,
    evaluate,
    simulate_with_prefetch,
)
from repro_torch.memsim.shared_llc import shared_llc_pass
from repro_torch.serve.interleave import INTERLEAVE_POLICIES, Interleave, interleave
from repro_torch.serve.tables import shared_table_streams

TABLE_MODES = ("per_tenant", "shared")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's query workload within a serving scenario."""

    kernel: str
    dataset: str
    seed: int = 0
    rate: float = 1.0  # relative request rate (the "rate" policy weight)
    target_elem_size: int = 8
    frontier_elem_size: int = 1

    def __post_init__(self):
        if not (np.isfinite(self.rate) and self.rate > 0):
            raise ValueError(f"tenant rate must be positive, got {self.rate}")

    def workload(self, hierarchy: HierarchyConfig) -> WorkloadSpec:
        return WorkloadSpec(
            kernel=self.kernel,
            dataset=self.dataset,
            hierarchy=hierarchy,
            seed=self.seed,
            target_elem_size=self.target_elem_size,
            frontier_elem_size=self.frontier_elem_size,
        )


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Declarative multi-tenant serving scenario.

    The hierarchy is shared (one LLC for everyone); per-tenant traces are
    ordinary cached workloads, so serving scenarios differing only in
    policy or table modes rebuild nothing.
    """

    tenants: Tuple[TenantSpec, ...]
    policy: str = "round_robin"
    table_modes: Tuple[str, ...] = TABLE_MODES
    hierarchy: HierarchyConfig = SCALED
    seed: int = 0  # scenario seed (rows inherit each tenant's own seed)

    # Duck-typing marker: Experiment routes these through the serving
    # protocol without importing it at declaration time.
    is_serve: ClassVar[bool] = True

    def __post_init__(self):
        object.__setattr__(self, "tenants", tuple(self.tenants))
        object.__setattr__(self, "table_modes", tuple(self.table_modes))
        if not self.tenants:
            raise ValueError("a serving scenario needs >= 1 tenant")
        for t in self.tenants:
            if not isinstance(t, TenantSpec):
                raise TypeError(f"tenants must be TenantSpec, got {t!r}")
        if self.policy not in INTERLEAVE_POLICIES:
            raise ValueError(
                f"unknown interleave policy {self.policy!r}; "
                f"available: {list(INTERLEAVE_POLICIES)}"
            )
        if not self.table_modes:
            raise ValueError("table_modes must be non-empty")
        for m in self.table_modes:
            if m not in TABLE_MODES:
                raise ValueError(
                    f"unknown table mode {m!r}; available: {list(TABLE_MODES)}"
                )

    @property
    def num_tenants(self) -> int:
        return len(self.tenants)

    def validate_names(self) -> None:
        for w in self.tenant_workloads():
            w.validate_names()

    def tenant_workloads(self) -> List[WorkloadSpec]:
        return [t.workload(self.hierarchy) for t in self.tenants]

    def rates(self) -> List[float]:
        return [t.rate for t in self.tenants]


@dataclasses.dataclass(frozen=True)
class ServeCell:
    """One (tenant, prefetcher, table-mode) score within a scenario."""

    tenant: int
    prefetcher: str
    table_mode: Optional[str]  # None for stateless (non-AMC) baselines
    metrics: PrefetchMetrics
    spec: WorkloadSpec


def _is_amc_generator(gen) -> bool:
    from repro_torch.core.amc.prefetcher import AMCPrefetcher

    return isinstance(getattr(gen, "__self__", None), AMCPrefetcher)


def _share_llc(
    outs: Sequence, il: Interleave, hierarchy: HierarchyConfig, device
) -> Tuple[List, List[dict]]:
    """Re-simulate K private LLC-input streams through one shared LLC on
    ``device``.

    Returns the outcomes with ``demand_llc_hit``/``pf_llc_in_dram`` patched
    to the contended hit masks, plus per-tenant counters of hits lost to
    contention (solo hit, shared miss — cross-tenant evictions)."""
    streams = []
    for k, o in enumerate(outs):
        # Private LLC events carry doubled positions (2p demand, 2p+1
        # prefetch); mapping p through the tenant's global-slot map yields
        # globally unique, order-preserving merge keys.
        pos2 = o.llc_in_pos2
        gkey = 2 * il.gmaps[k][pos2 // 2] + (pos2 & 1)
        streams.append((o.llc_in_blocks, gkey))
    hits = shared_llc_pass(
        streams, hierarchy.llc.sets, hierarchy.llc.ways, device=device
    )
    patched, lost = [], []
    for o, h in zip(outs, hits):
        is_pf = o.llc_in_is_pf
        d_hit, p_dram = h[~is_pf], (~h)[is_pf]
        lost.append(
            dict(
                llc_demand_hits_lost=int((o.demand_llc_hit & ~d_hit).sum()),
                llc_pf_hits_lost=int((~o.pf_llc_in_dram & p_dram).sum()),
            )
        )
        patched.append(
            dataclasses.replace(o, demand_llc_hit=d_hit, pf_llc_in_dram=p_dram)
        )
    return patched, lost


def _composite_outcome(trace: WorkloadTrace, pf_stream):
    """The composite (next-line + X) simulation of ``score_prefetcher``,
    keeping the LLC-input stream for the shared pass."""
    blocks = np.concatenate([trace.nl_blocks, pf_stream.blocks])
    pos = np.concatenate([trace.nl_pos, pf_stream.pos])
    issuer = np.concatenate(
        [
            np.zeros(len(trace.nl_blocks), np.int8),
            np.ones(len(pf_stream.blocks), np.int8),
        ]
    )
    return simulate_with_prefetch(
        trace.profile,
        blocks,
        pos,
        pf_issuer=issuer,
        metadata_bytes=pf_stream.metadata_bytes,
        keep_llc_stream=True,
    )


def score_serve(
    spec: ServeSpec,
    prefetchers: Sequence[Tuple[str, object]],
    traces: Sequence[WorkloadTrace],
) -> List[ServeCell]:
    """Score every prefetcher per tenant under the shared LLC.

    AMC-family generators run once per table mode; stateless baselines run
    once with ``table_mode=None``.  Deterministic given the traces — the
    serial/parallel parity of the serving protocol rests here.  The shared
    LLC runs on the first tenant's device (``Experiment`` builds every
    tenant on its one device).
    """
    wspecs = spec.tenant_workloads()
    device = traces[0].device
    with stage("serve_interleave"):
        il = interleave(
            [t.num_accesses for t in traces],
            rates=spec.rates(),
            policy=spec.policy,
        )
    with stage("serve_llc"):
        # Contended baselines: the composite (demand + next-line) runs of
        # all K tenants share the LLC too.  Re-simulated (bit-identical to
        # the cached nl_outcome) to capture the private LLC-input stream.
        base_outs = [
            simulate_with_prefetch(
                t.profile,
                t.nl_blocks,
                t.nl_pos,
                pf_issuer=np.zeros(len(t.nl_blocks), np.int8),
                keep_llc_stream=True,
            )
            for t in traces
        ]
        base_shared, base_lost = _share_llc(
            base_outs, il, spec.hierarchy, device
        )

    cells: List[ServeCell] = []
    for name, gen in prefetchers:
        modes: Tuple[Optional[str], ...] = (
            spec.table_modes if _is_amc_generator(gen) else (None,)
        )
        for mode in modes:
            with obs.span(
                "serve_cell",
                prefetcher=name,
                table_mode=mode,
                tenants=len(traces),
            ), stage("serve_score"):
                table_counters = None
                if mode == "shared":
                    streams, table_counters = shared_table_streams(
                        gen.__self__, traces, il
                    )
                else:  # per_tenant AMC tables, or a stateless baseline
                    streams = [gen(t) for t in traces]
                outs = [
                    _composite_outcome(t, s) for t, s in zip(traces, streams)
                ]
                shared_outs, lost = _share_llc(
                    outs, il, spec.hierarchy, device
                )
                for k, t in enumerate(traces):
                    m = evaluate(
                        name,
                        t.profile,
                        shared_outs[k],
                        baseline_outcome=base_shared[k],
                        eval_from_pos=t.eval_from_pos,
                        issuer=1,
                    )
                    m.info = dict(streams[k].info)
                    serve_info = dict(
                        tenant=k,
                        rate=spec.tenants[k].rate,
                        policy=spec.policy,
                        **lost[k],
                        baseline_llc_demand_hits_lost=base_lost[k][
                            "llc_demand_hits_lost"
                        ],
                    )
                    for key, v in lost[k].items():
                        obs.inc(f"serve.{key}", float(v))
                    if table_counters is not None:
                        serve_info["shared_table"] = dict(
                            {
                                key: v
                                for key, v in table_counters.items()
                                if key != "per_tenant"
                            },
                            **table_counters["per_tenant"][k],
                        )
                    m.info["serve"] = serve_info
                    cells.append(
                        ServeCell(
                            tenant=k,
                            prefetcher=name,
                            table_mode=mode,
                            metrics=m,
                            spec=wspecs[k],
                        )
                    )
    return cells


def run_serve(
    spec: ServeSpec,
    prefetchers,
    cache=None,
    workers: Optional[int] = None,
    verbose: bool = False,
    device: DeviceLike = None,
) -> "ServeResult":
    """Convenience wrapper: one serving scenario through Experiment on
    ``device`` (default the CUDA card)."""
    from repro_torch.core.experiment import Experiment

    exp = Experiment(
        workloads=[spec], prefetchers=prefetchers, cache=cache, device=device
    )
    result = exp.run(workers=workers, verbose=verbose)
    wspecs = spec.tenant_workloads()
    return ServeResult(
        spec=spec,
        cells=[
            ServeCell(
                tenant=c.tenant,
                prefetcher=c.prefetcher,
                table_mode=c.table_mode,
                metrics=c.metrics,
                spec=wspecs[c.tenant],
            )
            for c in result.cells
        ],
    )


@dataclasses.dataclass
class ServeResult:
    """Per-(tenant, prefetcher, mode) cells for one serving scenario."""

    spec: ServeSpec
    cells: List[ServeCell]

    def tenant_metrics(
        self, prefetcher: str, table_mode: Optional[str] = None
    ) -> List[PrefetchMetrics]:
        out = [
            c.metrics
            for c in sorted(self.cells, key=lambda c: c.tenant)
            if c.prefetcher == prefetcher and c.table_mode == table_mode
        ]
        if not out:
            have = sorted(
                {(c.prefetcher, c.table_mode) for c in self.cells},
                key=repr,
            )
            raise KeyError(
                f"({prefetcher!r}, {table_mode!r}) not in serve result; "
                f"have {have}"
            )
        return out

    def contention(self) -> dict:
        return contention_payload(self.spec, self.cells)


def contention_payload(spec: ServeSpec, cells: Sequence[ServeCell]) -> dict:
    """The ``serve-contention`` JSON document: per-tenant metric rows per
    (prefetcher, table mode) with the scenario's contention counters."""
    by_pf: Dict[str, Dict[str, List[ServeCell]]] = {}
    for c in cells:
        mode = c.table_mode if c.table_mode is not None else "stateless"
        by_pf.setdefault(c.prefetcher, {}).setdefault(mode, []).append(c)
    prefetchers = {}
    for name, by_mode in by_pf.items():
        modes = {}
        for mode, mode_cells in by_mode.items():
            mode_cells = sorted(mode_cells, key=lambda c: c.tenant)
            rows = [
                {
                    "tenant": c.tenant,
                    "kernel": c.spec.kernel,
                    "dataset": c.spec.dataset,
                    "seed": c.spec.seed,
                    "speedup": c.metrics.speedup,
                    "coverage": c.metrics.coverage,
                    "accuracy": c.metrics.accuracy,
                    "useful": c.metrics.useful,
                    "issued": c.metrics.issued,
                    "serve": c.metrics.info.get("serve"),
                }
                for c in mode_cells
            ]
            ms = [c.metrics for c in mode_cells]
            modes[mode] = {
                "per_tenant_rows": rows,
                "mean_coverage": float(np.mean([m.coverage for m in ms])),
                "mean_accuracy": float(np.mean([m.accuracy for m in ms])),
                "mean_speedup": float(np.mean([m.speedup for m in ms])),
            }
        prefetchers[name] = modes
    return {
        "schema": "serve-contention",
        "policy": spec.policy,
        "num_tenants": spec.num_tenants,
        "table_modes": list(spec.table_modes),
        "tenants": [
            {
                "kernel": t.kernel,
                "dataset": t.dataset,
                "seed": t.seed,
                "rate": t.rate,
            }
            for t in spec.tenants
        ],
        "prefetchers": prefetchers,
    }


__all__ = [
    "ServeCell",
    "ServeResult",
    "ServeSpec",
    "TABLE_MODES",
    "TenantSpec",
    "contention_payload",
    "run_serve",
    "score_serve",
]
