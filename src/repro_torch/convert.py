"""Build the port's carried state and graphs from plain numpy arrays.

The JAX package hands its :class:`CacheState` carries, demand-simulation
carries, CSR graphs and evolving pairs out as numpy arrays; these functions
turn such arrays into the port's objects, so a pass of the port can resume
exactly where a pass of the JAX package stopped (the cross-package shard
seam), and the port's apps can run on a pair the JAX package made.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.evolve import EvolvingGraphPair
from repro_torch.memsim.engine import CacheState
from repro_torch.memsim.hierarchy import DemandState


def cache_state(tags: np.ndarray, age: np.ndarray, device: DeviceLike = None) -> CacheState:
    """A :class:`CacheState` from ``(sets, ways)`` tag and age arrays."""
    dev = resolve_device(device)
    tags = np.asarray(tags)
    age = np.asarray(age)
    if tags.shape != age.shape or tags.ndim != 2:
        raise ValueError(f"tags {tags.shape} and age {age.shape} must be one (sets, ways) shape")
    return CacheState(
        torch.from_numpy(tags.astype(np.int32)).to(dev),
        torch.from_numpy(age.astype(np.int32)).to(dev),
    )


def demand_state(
    levels: Sequence[Tuple[np.ndarray, np.ndarray]],
    pos_offset: int,
    device: DeviceLike = None,
) -> DemandState:
    """A :class:`DemandState` from the L1, L2 and LLC ``(tags, age)`` pairs
    and the global position of the next access."""
    if len(levels) != 3:
        raise ValueError("a demand state has three levels: L1, L2, LLC")
    l1, l2, llc = (cache_state(t, a, device) for t, a in levels)
    return DemandState(l1=l1, l2=l2, llc=llc, pos_offset=int(pos_offset))


def csr_graph(
    offsets: np.ndarray,
    neighbors: np.ndarray,
    weights: Optional[np.ndarray] = None,
    name: str = "graph",
) -> CSRGraph:
    """A validated :class:`CSRGraph` over the same arrays (int64 offsets,
    int32 neighbors, float32 weights)."""
    g = CSRGraph(
        offsets=np.asarray(offsets, dtype=np.int64),
        neighbors=np.asarray(neighbors, dtype=np.int32),
        weights=None if weights is None else np.asarray(weights, dtype=np.float32),
        name=name,
    )
    g.validate()
    return g


def _graph(g) -> CSRGraph:
    return csr_graph(g.offsets, g.neighbors, g.weights, name=g.name)


def evolving_pair(base, run1, run2, mask1: np.ndarray, mask2: np.ndarray) -> EvolvingGraphPair:
    """An :class:`EvolvingGraphPair` from three CSR graphs (any objects with
    ``offsets``, ``neighbors``, ``weights`` and ``name``, such as the JAX
    package's) and the two presence masks."""
    return EvolvingGraphPair(
        base=_graph(base),
        run1=_graph(run1),
        run2=_graph(run2),
        mask1=np.asarray(mask1, dtype=bool),
        mask2=np.asarray(mask2, dtype=bool),
    )


__all__ = ["cache_state", "csr_graph", "demand_state", "evolving_pair"]
