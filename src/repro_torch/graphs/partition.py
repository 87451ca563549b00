"""Graph partitioning for the paper's 4-worker SPMD setup (METIS stand-in).

The paper partitions with METIS [27] into 4 parts processed by SPMD workers.
METIS is unavailable offline; we provide (1) a BFS reordering that clusters
connected neighborhoods into contiguous id ranges, followed by (2) balanced
contiguous-range partitioning — the standard lightweight approximation with
the same locality intent (neighbors land in the same part far more often
than random). The tracer simulates worker 0's private L1/L2 per Table VI.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.graphs.csr import CSRGraph, from_edges


def bfs_reorder(g: CSRGraph, seed: int = 0) -> np.ndarray:
    """Return ``order`` s.t. new_id = order[old_id], BFS-clustered."""
    n = g.num_vertices
    rng = np.random.default_rng(seed)
    visited = np.zeros(n, dtype=bool)
    order = np.full(n, -1, dtype=np.int64)
    nxt = 0
    # Iterative BFS from highest-degree roots (covers disconnected parts).
    roots = np.argsort(-g.degrees)
    for root in roots:
        if visited[root]:
            continue
        frontier = np.array([root], dtype=np.int64)
        visited[root] = True
        while len(frontier):
            for v in frontier:
                order[v] = nxt
                nxt += 1
            # gather all unvisited neighbors
            outs: List[np.ndarray] = []
            for v in frontier:
                s, e = g.offsets[v], g.offsets[v + 1]
                outs.append(g.neighbors[s:e])
            if outs:
                cand = np.unique(np.concatenate(outs))
                cand = cand[~visited[cand]]
            else:
                cand = np.empty(0, dtype=np.int64)
            visited[cand] = True
            frontier = cand
        if nxt >= n:
            break
    # Isolated leftovers.
    rest = np.flatnonzero(order < 0)
    order[rest] = np.arange(nxt, nxt + len(rest))
    _ = rng  # determinism hook
    return order


def partition_contiguous(
    g: CSRGraph, num_parts: int = 4, reorder: bool = True, seed: int = 0
) -> Tuple[List[CSRGraph], np.ndarray]:
    """Split into ``num_parts`` edge-balanced contiguous vertex ranges.

    Returns per-part CSR graphs (original id space, edges owned by the part's
    sources) plus the part assignment array.
    """
    n = g.num_vertices
    if reorder:
        order = bfs_reorder(g, seed=seed)
    else:
        order = np.arange(n, dtype=np.int64)
    # Edge-balanced split over the reordered vertex sequence.
    inv = np.argsort(order)
    deg_seq = g.degrees[inv]
    cum = np.cumsum(deg_seq)
    total = cum[-1] if len(cum) else 0
    bounds = np.searchsorted(cum, (np.arange(1, num_parts) * total) // num_parts)
    part_of_pos = np.zeros(n, dtype=np.int32)
    for i, b in enumerate(bounds):
        part_of_pos[b + 1 :] = i + 1  # noqa: E203
    part = np.zeros(n, dtype=np.int32)
    part[inv] = part_of_pos
    src = g.edge_sources()
    parts = []
    for p in range(num_parts):
        keep = part[src] == p
        w = g.weights[keep] if g.weights is not None else None
        parts.append(
            from_edges(
                src[keep], g.neighbors[keep], n, weights=w, dedup=False,
                name=f"{g.name}.p{p}",
            )
        )
    return parts, part


def edge_balance(parts: List[CSRGraph]) -> float:
    """max/mean edge count across parts (1.0 = perfectly balanced)."""
    counts = np.array([p.num_edges for p in parts], dtype=np.float64)
    return float(counts.max() / max(counts.mean(), 1e-9))
