"""Batched update-stream generators for multi-epoch evolving graphs
(ported from ``repro.stream.updates``).

Real evolving-graph deployments are long streams of batched edge/vertex
updates, not the single snapshot pair of the paper's §VI protocol.  This
module generates those streams *deterministically from a seed*: a churn
model turns a base :class:`~repro_torch.graphs.csr.CSRGraph` into an epoch-0 edge
set plus an ordered sequence of :class:`DeltaBatch` objects (edge inserts +
deletes), one per epoch boundary.  Everything is plain vectorized numpy,
copied from the JAX package with its rng draws in the same order; the
same ``(model, base, epochs, seed)`` always reproduces the same stream, so
update streams can participate in content-addressed artifact keys.

Churn models (all frozen/hashable, so they embed in ``StreamSpec``):

``SlidingWindow``
    The base edge list in a seeded arrival order, observed through a
    sliding window — epoch ``e`` holds the ``window_frac·m`` most recent
    arrivals, advancing ``step_frac·m`` per epoch (circular, so every epoch
    has the same edge count).  Models timestamped edge streams.
``PreferentialGrowth``
    Pure growth: each epoch inserts ``growth_frac·m`` new edges whose
    endpoints are sampled proportionally to current degree (+1) —
    rich-get-richer densification, no deletions.
``CommunityChurn``
    Vertices are hashed into communities; each epoch toggles a few whole
    communities in/out of the active set.  Models subgraph-level churn
    (tenants, partitions, regions appearing and disappearing).
``UniformChurn``
    The §VI protocol generalized to E epochs: epoch 0 activates
    ``init_frac`` of the vertices, then every boundary deletes
    ``del_frac`` of the active set and adds ``add_frac·n`` fresh vertices.
    For ``epochs=2`` the rng call sequence is exactly the legacy
    ``make_evolving_pair`` one, so the pair protocol is the E=2 special
    case, bit for bit.

Vertex-churn models also publish their per-epoch presence masks
(``UpdateStream.masks``); edge-stream models leave ``masks`` as ``None``
and presence is derived from degree.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, List, Optional, Tuple

import numpy as np

from repro_torch.graphs.csr import CSRGraph


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One epoch boundary's worth of edge updates (insert + delete sets)."""

    epoch: int  # the epoch this batch produces (1-based)
    add_src: np.ndarray  # int64
    add_dst: np.ndarray
    del_src: np.ndarray
    del_dst: np.ndarray
    add_w: Optional[np.ndarray] = None  # float32 weights for inserted edges

    @property
    def num_inserts(self) -> int:
        return int(len(self.add_src))

    @property
    def num_deletes(self) -> int:
        return int(len(self.del_src))

    @property
    def num_updates(self) -> int:
        return self.num_inserts + self.num_deletes

    def touched_vertices(self) -> np.ndarray:
        """Sorted unique vertex ids incident to any update in this batch."""
        return np.unique(
            np.concatenate(
                [self.add_src, self.add_dst, self.del_src, self.del_dst]
            ).astype(np.int64)
        )


@dataclasses.dataclass(frozen=True)
class UpdateStream:
    """Epoch-0 edge set + one :class:`DeltaBatch` per epoch boundary."""

    num_vertices: int
    init_src: np.ndarray
    init_dst: np.ndarray
    init_w: Optional[np.ndarray]
    batches: Tuple[DeltaBatch, ...]
    # Per-epoch active-vertex masks for vertex-churn models (len = epochs);
    # None for edge-stream models (presence is then degree-derived).
    masks: Optional[Tuple[np.ndarray, ...]] = None

    @property
    def num_epochs(self) -> int:
        return len(self.batches) + 1


def _mask_stream(base: CSRGraph, masks: List[np.ndarray]) -> UpdateStream:
    """Derive the edge-level update stream induced by a mask sequence.

    An edge is live in epoch ``e`` iff both endpoints are active; the batch
    into epoch ``e`` inserts edges that became live and deletes edges that
    stopped being live.  Weights of inserted edges come from the base graph.
    """
    src = base.edge_sources().astype(np.int64)
    dst = base.neighbors.astype(np.int64)
    w = base.weights
    prev = masks[0][src] & masks[0][dst]
    init_w = w[prev] if w is not None else None
    batches = []
    for e, m in enumerate(masks[1:], start=1):
        cur = m[src] & m[dst]
        add = cur & ~prev
        delete = prev & ~cur
        batches.append(
            DeltaBatch(
                epoch=e,
                add_src=src[add],
                add_dst=dst[add],
                del_src=src[delete],
                del_dst=dst[delete],
                add_w=w[add] if w is not None else None,
            )
        )
        prev = cur
    return UpdateStream(
        num_vertices=base.num_vertices,
        init_src=src[masks[0][src] & masks[0][dst]],
        init_dst=dst[masks[0][src] & masks[0][dst]],
        init_w=init_w,
        batches=tuple(batches),
        masks=tuple(masks),
    )


@dataclasses.dataclass(frozen=True)
class UniformChurn:
    """§VI vertex churn generalized to E epochs (E=2 == the paper pair)."""

    init_frac: float = 0.8
    del_frac: float = 0.10
    add_frac: float = 0.10
    kind: ClassVar[str] = "uniform_churn"

    def __post_init__(self):
        if not (0.0 < self.init_frac <= 1.0):
            raise ValueError(f"init_frac must be in (0, 1], got {self.init_frac}")
        if self.del_frac < 0 or self.add_frac < 0:
            raise ValueError("del_frac/add_frac must be >= 0")

    def masks(self, base: CSRGraph, epochs: int, seed: int) -> List[np.ndarray]:
        # The rng call sequence below (one choice for the initial mask, then
        # a delete-choice + add-choice per boundary) reproduces the legacy
        # make_evolving_pair draws exactly when epochs == 2.
        rng = np.random.default_rng(seed)
        n = base.num_vertices
        mask = np.zeros(n, dtype=bool)
        mask[rng.choice(n, size=int(self.init_frac * n), replace=False)] = True
        out = [mask]
        for _ in range(epochs - 1):
            cur = out[-1].copy()
            in_cur = np.flatnonzero(cur)
            out_cur = np.flatnonzero(~cur)
            n_del = int(self.del_frac * len(in_cur))
            n_add = min(int(self.add_frac * n), len(out_cur))
            cur[rng.choice(in_cur, size=n_del, replace=False)] = False
            cur[rng.choice(out_cur, size=n_add, replace=False)] = True
            out.append(cur)
        return out

    def generate(self, base: CSRGraph, epochs: int, seed: int) -> UpdateStream:
        return _mask_stream(base, self.masks(base, epochs, seed))


@dataclasses.dataclass(frozen=True)
class CommunityChurn:
    """Whole communities of vertices toggle in/out of the active set."""

    communities: int = 16
    active_frac: float = 0.75
    swap: int = 2  # communities toggled (each way) per epoch boundary
    kind: ClassVar[str] = "community_churn"

    def __post_init__(self):
        if self.communities < 2:
            raise ValueError("need at least 2 communities")
        if not (0.0 < self.active_frac < 1.0):
            raise ValueError("active_frac must be in (0, 1)")

    def masks(self, base: CSRGraph, epochs: int, seed: int) -> List[np.ndarray]:
        rng = np.random.default_rng(seed)
        comm = rng.integers(0, self.communities, size=base.num_vertices)
        active = np.zeros(self.communities, dtype=bool)
        n_active = max(int(round(self.active_frac * self.communities)), 1)
        active[rng.choice(self.communities, size=n_active, replace=False)] = True
        out = [active[comm]]
        for _ in range(epochs - 1):
            act = np.flatnonzero(active)
            inact = np.flatnonzero(~active)
            k = min(self.swap, len(act), len(inact))
            active = active.copy()
            active[rng.choice(act, size=k, replace=False)] = False
            active[rng.choice(inact, size=k, replace=False)] = True
            out.append(active[comm])
        return out

    def generate(self, base: CSRGraph, epochs: int, seed: int) -> UpdateStream:
        return _mask_stream(base, self.masks(base, epochs, seed))


@dataclasses.dataclass(frozen=True)
class SlidingWindow:
    """Timestamped edge stream seen through a sliding window."""

    window_frac: float = 0.75
    step_frac: float = 0.05
    kind: ClassVar[str] = "sliding_window"

    def __post_init__(self):
        if not (0.0 < self.window_frac <= 1.0):
            raise ValueError("window_frac must be in (0, 1]")
        if self.step_frac <= 0:
            raise ValueError("step_frac must be > 0")
        if self.window_frac + self.step_frac > 1.0:
            raise ValueError(
                "window_frac + step_frac must be <= 1 (the circular window "
                "may not lap itself within one epoch step)"
            )

    def generate(self, base: CSRGraph, epochs: int, seed: int) -> UpdateStream:
        rng = np.random.default_rng(seed)
        m = base.num_edges
        if m == 0:
            empty = np.zeros(0, np.int64)
            batches = tuple(
                DeltaBatch(e, empty, empty, empty, empty) for e in range(1, epochs)
            )
            return UpdateStream(base.num_vertices, empty, empty, None, batches)
        order = rng.permutation(m)  # seeded arrival order of the base edges
        src = base.edge_sources().astype(np.int64)[order]
        dst = base.neighbors.astype(np.int64)[order]
        w = base.weights[order] if base.weights is not None else None
        step = max(int(round(self.step_frac * m)), 1)
        # The fraction guard in __post_init__ bounds window+step on the
        # *fractions*; after integer rounding the sum can still exceed m
        # (e.g. 0.95+0.05 on m=10 rounds to 10+1), which would make leave
        # and enter indices coincide — a window that silently never moves
        # while the stats report churn.  Clamp so the window always slides.
        window = min(max(int(round(self.window_frac * m)), 1), max(m - step, 1))
        batches = []
        for e in range(1, epochs):
            start_prev = ((e - 1) * step) % m
            # Leaving: the ``step`` oldest arrivals of the previous window;
            # entering: the ``step`` arrivals past its end (circular).
            leave = (start_prev + np.arange(step)) % m
            enter = (start_prev + window + np.arange(step)) % m
            batches.append(
                DeltaBatch(
                    epoch=e,
                    add_src=src[enter],
                    add_dst=dst[enter],
                    del_src=src[leave],
                    del_dst=dst[leave],
                    add_w=w[enter] if w is not None else None,
                )
            )
        init = np.arange(window)
        return UpdateStream(
            num_vertices=base.num_vertices,
            init_src=src[init],
            init_dst=dst[init],
            init_w=w[init] if w is not None else None,
            batches=tuple(batches),
        )


@dataclasses.dataclass(frozen=True)
class PreferentialGrowth:
    """Rich-get-richer densification: insert-only preferential attachment."""

    growth_frac: float = 0.05  # new edges per epoch, as a fraction of base m
    kind: ClassVar[str] = "preferential_growth"

    def __post_init__(self):
        if self.growth_frac <= 0:
            raise ValueError("growth_frac must be > 0")

    def generate(self, base: CSRGraph, epochs: int, seed: int) -> UpdateStream:
        rng = np.random.default_rng(seed)
        n, m = base.num_vertices, base.num_edges
        deg = base.degrees.astype(np.float64) + 1.0
        k = max(int(round(self.growth_frac * max(m, 1))), 1)
        empty = np.zeros(0, np.int64)
        batches = []
        for e in range(1, epochs):
            p = deg / deg.sum()
            add_src = rng.choice(n, size=k, p=p).astype(np.int64)
            add_dst = rng.choice(n, size=k, p=p).astype(np.int64)
            keep = add_src != add_dst  # self loops would be dropped anyway
            add_src, add_dst = add_src[keep], add_dst[keep]
            np.add.at(deg, add_src, 1.0)
            np.add.at(deg, add_dst, 1.0)
            add_w = None
            if base.weights is not None:
                add_w = rng.integers(1, 16, size=len(add_src)).astype(np.float32)
            batches.append(
                DeltaBatch(
                    epoch=e,
                    add_src=add_src,
                    add_dst=add_dst,
                    del_src=empty,
                    del_dst=empty,
                    add_w=add_w,
                )
            )
        return UpdateStream(
            num_vertices=n,
            init_src=base.edge_sources().astype(np.int64),
            init_dst=base.neighbors.astype(np.int64),
            init_w=base.weights,
            batches=tuple(batches),
        )


CHURN_MODELS = {
    UniformChurn.kind: UniformChurn,
    CommunityChurn.kind: CommunityChurn,
    SlidingWindow.kind: SlidingWindow,
    PreferentialGrowth.kind: PreferentialGrowth,
}


__all__ = [
    "CHURN_MODELS",
    "CommunityChurn",
    "DeltaBatch",
    "PreferentialGrowth",
    "SlidingWindow",
    "UniformChurn",
    "UpdateStream",
]
