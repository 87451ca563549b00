"""Compressed-sparse-row graph container used by every app and the tracer.

Layout matches the paper's Fig 3 data-structure model:
  V (offsets)   -- vertex array: CSR row pointers, one slot per vertex (+1)
  N (neighbors) -- edge array: destination vertex ids, CSR order
  P (property)  -- per-vertex property array (rank / distance / component)
  F (frontier)  -- per-vertex bitmap of active vertices

Arrays are plain ``numpy`` on the host (graph construction is host-side data
plumbing) and are exported to torch tensors on a device via
:meth:`CSRGraph.device` for the apps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Immutable CSR graph. ``offsets`` has length n+1; ``neighbors`` length m."""

    offsets: np.ndarray  # int64 (n+1,)
    neighbors: np.ndarray  # int32 (m,)
    weights: Optional[np.ndarray] = None  # float32 (m,) for BellmanFord
    name: str = "graph"

    @property
    def num_vertices(self) -> int:
        return int(self.offsets.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.neighbors.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def avg_degree(self) -> float:
        n = max(self.num_vertices, 1)
        return self.num_edges / n

    def edge_sources(self) -> np.ndarray:
        """Expand CSR rows to a per-edge source array (int32, length m)."""
        return np.repeat(
            np.arange(self.num_vertices, dtype=np.int32), self.degrees
        )

    def transpose(self) -> "CSRGraph":
        """The CSC view: in-edges of this graph as a CSR graph over the
        same vertex id space (row ``d`` lists the sources of ``d``'s
        in-edges; weights are carried per edge).

        Pull-mode (dense) EDGEMAP traverses this view — destinations scan
        their in-edge rows sequentially and gather source properties.  The
        transpose is built once per graph and cached on the instance, so
        every pull step and the pull-mode tracer share one CSC build.
        """
        t = self.__dict__.get("_transpose")
        if t is None:
            src = self.edge_sources()
            t = from_edges(
                self.neighbors,
                src,
                self.num_vertices,
                weights=self.weights,
                dedup=False,
                name=self.name + "^T",
            )
            object.__setattr__(self, "_transpose", t)
        return t

    def device(self, device: torch.device):
        """Return (offsets, neighbors, weights, edge_src) as tensors on
        ``device`` (int64, int32, float32, int32)."""
        w = self.weights
        if w is None:
            w = np.ones(self.num_edges, dtype=np.float32)
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (self.offsets, self.neighbors, w, self.edge_sources())
        )

    def validate(self) -> None:
        n, m = self.num_vertices, self.num_edges
        assert self.offsets[0] == 0 and self.offsets[-1] == m
        assert np.all(np.diff(self.offsets) >= 0), "offsets must be monotone"
        if m:
            assert self.neighbors.min() >= 0 and self.neighbors.max() < n
        if self.weights is not None:
            assert self.weights.shape == (m,)


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    num_vertices: int,
    weights: Optional[np.ndarray] = None,
    dedup: bool = True,
    name: str = "graph",
) -> CSRGraph:
    """Build a CSR graph from an edge list (drops self loops, dedups)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float32)[keep]
    if dedup and len(src):
        key = src * num_vertices + dst
        order = np.argsort(key, kind="stable")
        key = key[order]
        uniq = np.ones(len(key), dtype=bool)
        uniq[1:] = key[1:] != key[:-1]
        src, dst = src[order][uniq], dst[order][uniq]
        if weights is not None:
            weights = weights[order][uniq]
    else:
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        if weights is not None:
            weights = weights[order]
    counts = np.bincount(src, minlength=num_vertices).astype(np.int64)
    offsets = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    g = CSRGraph(
        offsets=offsets,
        neighbors=dst.astype(np.int32),
        weights=weights,
        name=name,
    )
    g.validate()
    return g


def build_csr(edges: np.ndarray, num_vertices: int, **kw) -> CSRGraph:
    """Convenience: edges is an (m, 2) array."""
    return from_edges(edges[:, 0], edges[:, 1], num_vertices, **kw)


def induced_subgraph(g: CSRGraph, keep_mask: np.ndarray, name: str) -> CSRGraph:
    """Induced subgraph on ``keep_mask`` vertices, original id space.

    Vertex ids are PRESERVED (vertices are masked, not compacted): the
    property/target arrays stay indexed by original vertex id across graph
    versions, which is what keeps access-to-miss correlations recorded on
    one version partially valid on the next — the effect AMC exploits.
    """
    src = g.edge_sources()
    dst = g.neighbors
    e_keep = keep_mask[src] & keep_mask[dst]
    w = g.weights[e_keep] if g.weights is not None else None
    return from_edges(
        src[e_keep], dst[e_keep], g.num_vertices, weights=w, dedup=False, name=name
    )


def symmetrize(g: CSRGraph) -> CSRGraph:
    """Return the undirected version of ``g`` (both edge directions)."""
    src = g.edge_sources()
    dst = g.neighbors.astype(np.int64)
    w = g.weights
    if w is not None:
        w = np.concatenate([w, w])
    return from_edges(
        np.concatenate([src, dst]),
        np.concatenate([dst, src]),
        g.num_vertices,
        weights=w,
        name=g.name + "+sym",
    )
