"""Shared-LLC pass for multi-tenant serving (``repro_torch.serve``; ported
from ``repro.memsim.shared_llc``).

K tenants run private L1/L2 hierarchies on their own substreams, but the
last-level cache is one physical resource: its eviction state is driven by
the *interleaved* miss stream of every tenant.  This module re-simulates
the per-tenant LLC-input event streams (captured by
``simulate_with_prefetch(..., keep_llc_stream=True)``) through a single
:func:`~repro_torch.memsim.engine.cache_pass` over the globally merged stream:
on the card, one launch of kernel K1 (``lru_hits``), which takes int32
blocks, so the shifted namespace must stay below ``2**31``.

Two invariants make the result both honest and regression-safe:

- **Namespace disjointness.**  Tenants are independent address spaces
  (every dataset is laid out from the same ``TraceConfig`` base), so
  tenant k's block ids are offset by ``k << shift``.  ``shift`` covers the
  largest block id *and* the LLC set-index width, so (a) tenants can never
  false-share a line and (b) each block keeps its private set index —
  contention changes LRU depth within a set, never the set mapping.

- **K=1 identity.**  With one tenant the offset is zero and the merge
  order is the identity, so the shared pass feeds ``cache_pass`` the exact
  private LLC stream — hit masks (and therefore every metric downstream)
  are bit-identical to the single-tenant path.  This is the serving
  subsystem's parity anchor, asserted in ``tests/test_torch_serve.py``.

The merge (shift, concatenate, stable argsort of the keys) is host numpy
in int64, as in the JAX package; only the cache pass goes to the device.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.memsim.engine import cache_pass


def tenant_shift(max_block: int, sets: int) -> int:
    """Offset exponent disambiguating tenant block namespaces.

    Covers the largest block id (disjointness) and the set-index width
    (``(k << shift) & (sets - 1) == 0``, so per-tenant set mapping is
    preserved — sets are powers of two throughout the simulator).
    """
    block_bits = int(max_block).bit_length()
    set_bits = int(sets - 1).bit_length() if sets > 1 else 0
    return max(block_bits, set_bits)


def shared_llc_pass(
    streams: Sequence[Tuple[np.ndarray, np.ndarray]],
    sets: int,
    ways: int,
    device: DeviceLike = None,
) -> List[np.ndarray]:
    """Simulate one shared LLC over K interleaved tenant streams.

    ``streams`` holds one ``(blocks, order_key)`` pair per tenant: the
    tenant's LLC-input block ids in its private simulation order, and a
    global ordering key per event (nondecreasing within a tenant; distinct
    tenants never tie — the serving interleaver derives keys from globally
    unique slot numbers).  The pass runs on ``device`` (default the CUDA
    card).  Returns the per-tenant hit masks, each in the tenant's
    original event order.
    """
    total = sum(len(b) for b, _ in streams)
    if total == 0:
        return [np.zeros(0, dtype=bool) for _ in streams]
    max_block = max((int(b.max()) if len(b) else 0) for b, _ in streams)
    shift = tenant_shift(max_block, sets)
    top = ((len(streams) - 1) << shift) | max_block
    if top >= 2**31:
        raise ValueError(
            f"shared-LLC block namespace overflows int32: "
            f"{len(streams)} tenants x max block {max_block} needs "
            f"{top.bit_length()} bits"
        )
    blocks = np.concatenate(
        [b.astype(np.int64) + (k << shift) for k, (b, _) in enumerate(streams)]
    )
    keys = np.concatenate([k for _, k in streams])
    # Stable: within-tenant ties (several prefetches at one slot) keep
    # their private simulation order; cross-tenant keys never tie.
    order = np.argsort(keys, kind="stable")
    hits_merged = cache_pass(blocks[order], sets, ways, device=device)
    hits = np.empty(total, dtype=bool)
    hits[order] = hits_merged
    out, start = [], 0
    for b, _ in streams:
        out.append(hits[start : start + len(b)])
        start += len(b)
    return out


__all__ = ["shared_llc_pass", "tenant_shift"]
