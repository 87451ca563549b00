"""Delta-CSR snapshots: apply update batches, yielding an epoch sequence
(ported from ``repro.stream.snapshots``; numpy on the host).

``snapshot_sequence`` turns (base graph, churn model, epochs, seed) into the
epoch graphs ``g_0, g_1, …, g_{E-1}`` plus per-epoch churn statistics —
the multi-epoch generalization of :class:`repro_torch.graphs.evolve.
EvolvingGraphPair`.  Two construction paths:

- **Vertex-churn models** (those publishing presence masks) build each
  epoch with ``induced_subgraph`` on the *base* graph — the exact legacy
  §VI construction, so the E=2 uniform-churn sequence gives the masks and
  CSR arrays of ``make_evolving_pair``.
- **Edge-stream models** (sliding window, preferential growth) start from
  the stream's epoch-0 edge set and fold each :class:`DeltaBatch` in with
  :func:`apply_delta` (key-based vectorized delete + concatenated insert).

Vertex ids are never compacted: all epochs share the base id space, so the
property/frontier address layout — and therefore AMC's recorded
correlations — stay commensurable across the whole stream.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.graphs.csr import CSRGraph, from_edges, induced_subgraph
from repro_torch.stream.updates import DeltaBatch, UpdateStream


def apply_delta(graph: CSRGraph, batch: DeltaBatch, name: str) -> CSRGraph:
    """Apply one update batch to ``graph``, returning the next snapshot.

    Deletes are matched by (src, dst) key with ``np.isin``; inserts are
    concatenated and the result re-canonicalized through ``from_edges``
    (sorted by (src, dst), deduped) — so the output is independent of how
    its edge set was reached, and delta application composes with the
    induced-subgraph construction bit for bit.
    """
    n = graph.num_vertices
    src = graph.edge_sources().astype(np.int64)
    dst = graph.neighbors.astype(np.int64)
    w = graph.weights
    if batch.num_deletes:
        key = src * n + dst
        del_key = batch.del_src * n + batch.del_dst
        keep = ~np.isin(key, del_key)
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]
    new_src = np.concatenate([src, batch.add_src])
    new_dst = np.concatenate([dst, batch.add_dst])
    new_w = None
    if w is not None:
        add_w = batch.add_w
        if add_w is None:
            add_w = np.ones(batch.num_inserts, dtype=np.float32)
        new_w = np.concatenate([w, add_w])
    return from_edges(new_src, new_dst, n, weights=new_w, dedup=True, name=name)


@dataclasses.dataclass(frozen=True)
class EpochStats:
    """Churn accounting for one epoch of a snapshot sequence."""

    epoch: int
    active_vertices: int
    num_edges: int
    edges_added: int  # via the batch producing this epoch (0 for epoch 0)
    edges_deleted: int
    vertex_overlap: float  # |active_e ∩ active_{e-1}| / |active_{e-1}|
    cumulative_overlap: float  # |active_e ∩ active_0| / |active_0|
    edge_churn: float  # (added + deleted) / max(previous epoch edges, 1)

    def row(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SnapshotSequence:
    """E epoch graphs in a shared id space + the deltas between them."""

    base: CSRGraph
    seed: int
    graphs: List[CSRGraph]
    masks: List[np.ndarray]  # per-epoch active-vertex masks
    batches: List[DeltaBatch]  # len E-1; batches[e-1] produces graphs[e]
    stats: List[EpochStats]
    churn: object = None  # the generating churn model, when known

    @property
    def num_epochs(self) -> int:
        return len(self.graphs)

    @property
    def max_edges(self) -> int:
        """Edge-array size of the shared cross-epoch address layout."""
        return max(g.num_edges for g in self.graphs)

    def changed_vertices(self, epoch: int) -> np.ndarray:
        """Sorted unique vertex ids whose neighborhood or presence changed
        across the boundary into ``epoch`` (1 <= epoch < num_epochs).

        This is the invalidation set of the ``invalidate_changed`` table
        lifecycle policy: correlation entries triggered by these vertices
        were recorded against a neighborhood that no longer exists.
        """
        if not (1 <= epoch < self.num_epochs):
            raise IndexError(f"epoch {epoch} has no inbound boundary")
        touched = self.batches[epoch - 1].touched_vertices()
        toggled = np.flatnonzero(self.masks[epoch] != self.masks[epoch - 1])
        return np.unique(np.concatenate([touched, toggled.astype(np.int64)]))


def _active_mask(g: CSRGraph) -> np.ndarray:
    """Presence for edge-stream epochs: vertices with at least one edge."""
    mask = g.degrees > 0
    if g.num_edges:
        mask = mask.copy()
        mask[np.unique(g.neighbors)] = True
    return mask


def snapshot_sequence(
    base: CSRGraph,
    churn,
    epochs: int,
    seed: int = 0,
    stream: Optional[UpdateStream] = None,
) -> SnapshotSequence:
    """Materialize the epoch sequence of ``churn`` applied to ``base``.

    ``stream`` overrides the generated update stream (for caller-supplied
    update sequences); otherwise ``churn.generate(base, epochs, seed)``
    produces it.  Wrapped in the ``update_apply`` stage timer, so the
    per-epoch graph construction cost shows in a stage breakdown.
    """
    from repro_torch.core.exec.timers import stage

    if epochs < 1:
        raise ValueError(f"epochs must be >= 1, got {epochs}")
    if stream is None:
        stream = churn.generate(base, epochs, seed)
    if stream.num_epochs != epochs:
        raise ValueError(
            f"update stream has {stream.num_epochs} epochs, expected {epochs}"
        )
    with stage("update_apply"):
        if stream.masks is not None:
            # Vertex churn: the legacy induced-subgraph construction (exact
            # §VI arrays); the delta path is equivalent and test-asserted.
            masks = [np.asarray(m) for m in stream.masks]
            graphs = [
                induced_subgraph(base, m, f"{base.name}@e{k}")
                for k, m in enumerate(masks)
            ]
        else:
            g = from_edges(
                stream.init_src,
                stream.init_dst,
                base.num_vertices,
                weights=stream.init_w,
                dedup=True,
                name=f"{base.name}@e0",
            )
            graphs = [g]
            for k, batch in enumerate(stream.batches, start=1):
                g = apply_delta(g, batch, name=f"{base.name}@e{k}")
                graphs.append(g)
            masks = [_active_mask(g) for g in graphs]

    stats: List[EpochStats] = []
    for k, g in enumerate(graphs):
        active = int(masks[k].sum())
        if k == 0:
            stats.append(
                EpochStats(
                    epoch=0,
                    active_vertices=active,
                    num_edges=g.num_edges,
                    edges_added=0,
                    edges_deleted=0,
                    vertex_overlap=1.0,
                    cumulative_overlap=1.0,
                    edge_churn=0.0,
                )
            )
            continue
        batch = stream.batches[k - 1]
        prev_active = masks[k - 1]
        stats.append(
            EpochStats(
                epoch=k,
                active_vertices=active,
                num_edges=g.num_edges,
                edges_added=batch.num_inserts,
                edges_deleted=batch.num_deletes,
                vertex_overlap=float(
                    (masks[k] & prev_active).sum() / max(prev_active.sum(), 1)
                ),
                cumulative_overlap=float(
                    (masks[k] & masks[0]).sum() / max(masks[0].sum(), 1)
                ),
                edge_churn=float(
                    batch.num_updates / max(graphs[k - 1].num_edges, 1)
                ),
            )
        )
    return SnapshotSequence(
        base=base,
        seed=seed,
        graphs=graphs,
        masks=masks,
        batches=list(stream.batches),
        stats=stats,
        churn=churn,
    )


__all__ = ["EpochStats", "SnapshotSequence", "apply_delta", "snapshot_sequence"]
