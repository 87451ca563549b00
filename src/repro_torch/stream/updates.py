"""Batched update streams for evolving graphs (ported from ``repro.stream.updates``).

A churn model turns a base :class:`~repro_torch.graphs.csr.CSRGraph` into
an epoch-0 edge set plus an ordered sequence of :class:`DeltaBatch`
objects (edge inserts + deletes), one per epoch boundary, deterministically
from a seed.  Everything is plain numpy, copied from the JAX package with
its rng draws in the same order, so the masks and edge sets are identical.

Ported so far: ``UniformChurn``, the §VI protocol generalized to E epochs
(epoch 0 activates ``init_frac`` of the vertices, then every boundary
deletes ``del_frac`` of the active set and adds ``add_frac·n`` fresh
vertices).  For ``epochs=2`` it is the paper's two-run pair, which
:func:`repro_torch.graphs.evolve.make_evolving_pair` builds.  The
edge-stream and community models come with the streaming subsystem.
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


__all__ = ["DeltaBatch", "UniformChurn", "UpdateStream"]
