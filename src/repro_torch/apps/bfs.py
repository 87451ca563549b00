"""Breadth-First Search (Ligra BFS) — frontier-parallel parent assignment.

For the evolving-graph protocol the kernel is run twice (run-1 / run-2
inputs from :mod:`repro_torch.graphs.evolve`); the paper evaluates the
second run.

Registered as ``bfs`` (push) with a ``bfs_do`` variant running Ligra's
direction-optimizing switch: wide middle levels go dense (pull over
in-edges), narrow head/tail levels stay sparse (push).  Parents are
identical in every direction (min-id offer wins).

The step runs on the device.  Parents stay float32 with ``big = n + 1``
as in the JAX package (vertex ids are exact in float32 below 2^24), and
the min-offer goes through ``scatter_reduce`` ``amin``
(:func:`~repro_torch.apps.ligra.edge_map_min`), which does not depend on
the order of the edges, so frontiers equal the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.ligra import (
    AppRun,
    edge_endpoints,
    edge_map_min,
    run_iterations,
    step_directions,
)
from repro_torch.apps.registry import register_kernel, register_kernel_variant
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.csr import CSRGraph


def pick_root(graph: CSRGraph, present_mask: np.ndarray | None = None) -> int:
    """Deterministic root: highest out-degree present vertex."""
    deg = graph.degrees.copy()
    if present_mask is not None:
        deg = np.where(present_mask, deg, -1)
    return int(np.argmax(deg))


@register_kernel(
    "bfs",
    epoch_protocol="per_run",
    needs_root=True,
    directions=("push", "pull", "auto"),
    description="Breadth-First Search (run twice on evolving inputs)",
)
def bfs(
    graph: CSRGraph,
    root: int | None = None,
    max_iters: int = 200,
    present_mask: np.ndarray | None = None,
    direction: str = "push",
    device: DeviceLike = None,
) -> AppRun:
    dev = resolve_device(device)
    n = graph.num_vertices
    if root is None:
        root = pick_root(graph, present_mask)

    present = torch.from_numpy(
        np.asarray(present_mask if present_mask is not None else np.ones(n, dtype=bool))
    ).to(dev)
    big = float(n + 1)

    def make_step(src_e, dst_e, _w):
        src_f = src_e.to(torch.float32)

        def step(state, frontier_mask):
            (parent,) = state
            # Active sources offer themselves as parent; min-id wins (Ligra's
            # CAS winner is arbitrary; min makes it deterministic — and
            # direction-independent).
            offer = edge_map_min(src_e, dst_e, src_f, frontier_mask, n, big)
            unvisited = parent >= big
            newly = unvisited & (offer < big) & present
            new_parent = torch.where(newly, offer, parent)
            return (new_parent,), newly, ~newly.any()

        return step

    steps = {
        d: make_step(*edge_endpoints(graph, d, dev)) for d in step_directions(direction)
    }

    parent0 = torch.full((n,), big, dtype=torch.float32, device=dev)
    parent0[root] = root
    init_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    init_mask[root] = True

    return run_iterations(
        name="bfs",
        graph=graph,
        init_state=(parent0,),
        init_frontier_mask=init_mask,
        max_iters=max_iters,
        extract_values=lambda s: s[0],
        steps=steps,
        direction=direction,
    )


register_kernel_variant(
    "bfs_do",
    base="bfs",
    direction="auto",
    description="Direction-optimizing BFS (Ligra dense/sparse switch)",
)
