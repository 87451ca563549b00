"""Ligra-style frontier primitives in PyTorch, in both traversal directions.

``edge_map_*`` applies a per-edge message from *active sources* and
segment-reduces into destinations — Ligra's EDGEMAP.  The same reduction
runs in either direction; what changes is the per-edge array order it runs
over (and therefore the memory-access modality the tracer emits):

- **push** (sparse): edges in CSR (out-edge) order.
- **pull** (dense): edges in CSC (in-edge) order via
  :meth:`~repro_torch.graphs.csr.CSRGraph.transpose`.
- **auto**: Ligra's direction-optimizing switch — an iteration goes dense
  when the frontier plus its out-edges exceed ``|E| / dense_threshold``.

The reduction runs over the full edge set with an activity mask, on the
device.  A float sum must add each destination's contributions in edge
order, as ``jax.ops.segment_sum`` does in the JAX package, because PGD
thresholds on the result: :func:`_segment_sum` goes through the ordered
segment-sum kernel (:mod:`repro_torch.kernels.segment_sum`) on the GPU and
``index_add_`` on the CPU.  A min is order-free and uses ``scatter_reduce``.

Apps drive a host iteration loop around their step functions and collect
per-iteration frontiers (and directions) on the host for the tracer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.graphs.csr import CSRGraph
from repro_torch.kernels.segment_sum.segment_sum import SegmentPlan, segment_sum

# Ligra's dense/sparse threshold denominator: an iteration runs dense
# (pull) when |frontier| + outdeg(frontier) > |E| / DENSE_THRESHOLD.
DENSE_THRESHOLD = 20


@dataclasses.dataclass
class AppRun:
    """Result of running one kernel on one input graph."""

    name: str
    graph: CSRGraph
    frontiers: List[np.ndarray]  # iteration -> sorted active vertex ids
    values: np.ndarray  # final property array (rank / comp / parent / dist)
    num_iters: int
    stats: dict
    directions: Optional[List[str]] = None  # per-iteration "push" | "pull"

    @property
    def total_active(self) -> int:
        return int(sum(len(f) for f in self.frontiers))

    def iteration_directions(self) -> List[str]:
        """Per-iteration traversal direction ("push" for legacy runs)."""
        if self.directions is not None:
            return self.directions
        return ["push"] * len(self.frontiers)

    def frontier_masks(self, n: Optional[int] = None) -> List[np.ndarray]:
        n = n or self.graph.num_vertices
        out = []
        for f in self.frontiers:
            m = np.zeros(n, dtype=bool)
            m[f] = True
            out.append(m)
        return out


def _segment_sum(data: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Per-destination float sums, added in edge order."""
    return segment_sum(data, plan)


def _segment_min(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """Per-destination minimum; the dtype's maximum where a segment is empty
    (``jax.ops.segment_min``'s identity)."""
    ident = float("inf") if data.dtype.is_floating_point else torch.iinfo(data.dtype).max
    out = torch.full((num_segments,), ident, dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, segment_ids.long(), data, "amin", include_self=True)


def edge_map_sum(edge_src, plan: SegmentPlan, per_edge_value, frontier_mask):
    """sum_{(s,d) in E, s active} value[e] into dest slots; 0 elsewhere."""
    contrib = torch.where(frontier_mask[edge_src], per_edge_value, 0.0)
    return _segment_sum(contrib, plan)


def edge_map_min(edge_src, neighbors, per_edge_value, frontier_mask, n, big):
    """min over active in-edges per destination; ``big`` where none."""
    contrib = torch.where(frontier_mask[edge_src], per_edge_value, big)
    return _segment_min(contrib, neighbors, n)


def edge_endpoints(graph: CSRGraph, direction: str, device: torch.device):
    """Per-edge ``(source, destination, weight)`` tensors on ``device`` for
    one traversal direction.

    Push uses CSR (out-edge) order; pull uses the cached CSC transpose, so
    edges appear in in-edge order — same (source, destination, weight)
    multiset, different traversal order.
    """
    if direction == "push":
        _, neighbors, weights, edge_src = graph.device(device)
        return edge_src, neighbors, weights
    if direction == "pull":
        _, in_sources, weights, edge_dst = graph.transpose().device(device)
        return in_sources, edge_dst, weights
    raise ValueError(f"direction must be 'push' or 'pull'; got {direction!r}")


def step_directions(direction: str) -> tuple:
    """The concrete step directions a kernel must build for ``direction``."""
    if direction == "auto":
        return ("push", "pull")
    if direction in ("push", "pull"):
        return (direction,)
    raise ValueError(f"unknown traversal direction {direction!r}")


def run_iterations(
    name: str,
    graph: CSRGraph,
    init_state: tuple,
    init_frontier_mask: torch.Tensor,
    step_fn: Optional[Callable] = None,
    max_iters: int = 100,
    extract_values: Callable = None,
    min_frontier: int = 1,
    *,
    steps: Optional[Dict[str, Callable]] = None,
    direction: str = "push",
    dense_threshold: int = DENSE_THRESHOLD,
) -> AppRun:
    """Generic host loop: step(state, frontier_mask) -> (state, new_mask, done).

    ``steps`` maps a traversal direction to its step function; a bare
    ``step_fn`` is shorthand for ``steps={"push": step_fn}``.  Under
    ``direction="auto"`` each iteration picks dense (pull) or sparse (push)
    by Ligra's frontier threshold, recorded on the returned :class:`AppRun`.
    The loop stops at the first ``done`` (converged) step.
    """
    if steps is None:
        if step_fn is None:
            raise ValueError("pass step_fn or steps={direction: fn}")
        steps = {"push": step_fn}
    for d in step_directions(direction):
        if d not in steps:
            raise ValueError(
                f"direction {direction!r} needs a {d!r} step; have {sorted(steps)}"
            )
    out_deg = np.asarray(graph.degrees, dtype=np.int64)
    dense_cut = graph.num_edges / dense_threshold
    frontiers: List[np.ndarray] = []
    directions: List[str] = []
    mask = init_frontier_mask
    state = init_state
    iters = 0
    for _ in range(max_iters):
        active = np.flatnonzero(mask.cpu().numpy())
        if len(active) < min_frontier:
            break
        if direction == "auto":
            d = (
                "pull"
                if len(active) + int(out_deg[active].sum()) > dense_cut
                else "push"
            )
        else:
            d = direction
        frontiers.append(active.astype(np.int64))
        directions.append(d)
        state, mask, done = steps[d](state, mask)
        iters += 1
        if bool(done):
            break
    values = extract_values(state).cpu().numpy()
    return AppRun(
        name=name,
        graph=graph,
        frontiers=frontiers,
        values=values,
        num_iters=iters,
        stats={
            "iters": iters,
            "total_active": int(sum(len(f) for f in frontiers)),
            "dense_iters": directions.count("pull"),
        },
        directions=directions,
    )
