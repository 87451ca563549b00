"""Deterministic multi-tenant trace interleaver (ported from
``repro.serve.interleave``; host numpy, float64 virtual times, as in the
JAX package, so the merged order is the same for any rates).

K independent query traces merge into one global access stream under a
virtual-time discipline: tenant ``k``'s ``i``-th access is stamped with
finish time ``(i + 1) / rate_k`` and the global stream is the stable sort
of all stamps (ties broken by tenant id, so equal-rate tenants alternate
in strict round-robin).  The merge is a pure function of
``(lengths, rates, policy)`` — no RNG, no host state — which is what makes
serving results reproducible and the serial/parallel parity gate possible.

Two properties the serving subsystem builds on (asserted in
``tests/test_torch_serve.py``):

- **Order preservation.**  Within a tenant, global slots are strictly
  increasing in private position (``gmaps[k]`` is sorted), so per-tenant
  simulation order survives interleaving and deinterleaving is a bit-exact
  roundtrip.
- **Coverage.**  Every global slot belongs to exactly one tenant
  (``tenant_of`` partitions ``arange(total)`` via ``gmaps``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

INTERLEAVE_POLICIES = ("round_robin", "rate")


@dataclasses.dataclass
class Interleave:
    """The merged order of K tenant streams.

    ``tenant_of[g]`` is the tenant owning global slot ``g``;
    ``gmaps[k][i]`` is the global slot of tenant ``k``'s ``i``-th access.
    """

    policy: str
    rates: np.ndarray  # (K,) effective rates (all ones under round_robin)
    tenant_of: np.ndarray  # (total,) int32
    gmaps: List[np.ndarray]  # per tenant: private pos -> global slot

    @property
    def num_tenants(self) -> int:
        return len(self.gmaps)

    @property
    def total(self) -> int:
        return len(self.tenant_of)


def interleave(
    lengths: Sequence[int],
    rates: Optional[Sequence[float]] = None,
    policy: str = "round_robin",
) -> Interleave:
    """Merge K per-tenant streams of the given lengths into one order."""
    if policy not in INTERLEAVE_POLICIES:
        raise ValueError(
            f"unknown interleave policy {policy!r}; "
            f"available: {list(INTERLEAVE_POLICIES)}"
        )
    k_tenants = len(lengths)
    if k_tenants == 0:
        raise ValueError("interleave needs at least one tenant")
    if policy == "round_robin" or rates is None:
        r = np.ones(k_tenants, dtype=np.float64)
    else:
        r = np.asarray(list(rates), dtype=np.float64)
        if len(r) != k_tenants:
            raise ValueError(
                f"{len(r)} rates for {k_tenants} tenants — must match"
            )
        if not np.all(np.isfinite(r)) or np.any(r <= 0):
            raise ValueError(f"rates must be positive and finite, got {r}")
    total = int(sum(lengths))
    vtime = np.concatenate(
        [
            (np.arange(n, dtype=np.float64) + 1.0) / r[k]
            for k, n in enumerate(lengths)
        ]
    ) if total else np.zeros(0, dtype=np.float64)
    tenant = np.concatenate(
        [np.full(n, k, dtype=np.int32) for k, n in enumerate(lengths)]
    ) if total else np.zeros(0, dtype=np.int32)
    # lexsort: last key is primary -> sort by virtual time, ties by tenant.
    order = np.lexsort((tenant, vtime))
    tenant_of = tenant[order]
    gpos = np.empty(total, dtype=np.int64)
    gpos[order] = np.arange(total, dtype=np.int64)
    gmaps, start = [], 0
    for n in lengths:
        gmaps.append(gpos[start : start + n])
        start += n
    return Interleave(policy=policy, rates=r, tenant_of=tenant_of, gmaps=gmaps)


def deinterleave(il: Interleave) -> List[np.ndarray]:
    """Per-tenant global-slot index arrays, in private stream order.

    ``global_stream[deinterleave(il)[k]]`` recovers tenant ``k``'s private
    stream bit-exactly (the roundtrip property).  Equal to ``il.gmaps``
    but recomputed from ``tenant_of`` alone, so the roundtrip test
    exercises both representations against each other.
    """
    return [
        np.flatnonzero(il.tenant_of == k).astype(np.int64)
        for k in range(il.num_tenants)
    ]


__all__ = ["INTERLEAVE_POLICIES", "Interleave", "deinterleave", "interleave"]
