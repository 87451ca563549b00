"""BellmanFord SSSP (Ligra) — edge relaxation with a change frontier.

Push relaxes out-edges of changed vertices; pull scans in-edges per
destination (weights ride the CSC transpose).  Distances are identical in
either direction (min is order-free).

The step runs on the device in float32 with the JAX package's ``inf`` of
3.0e38 (not ``+inf``); the candidate ``dist[src] + w`` is one float32 add
and the min goes through ``scatter_reduce`` ``amin``, so distances and
frontiers equal the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.bfs import pick_root
from repro_torch.apps.ligra import (
    AppRun,
    edge_endpoints,
    edge_map_min,
    run_iterations,
    step_directions,
)
from repro_torch.apps.registry import register_kernel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.csr import CSRGraph

INF = 3.0e38


@register_kernel(
    "bellmanford",
    weighted=True,
    epoch_protocol="per_run",
    needs_root=True,
    directions=("push", "pull", "auto"),
    description="BellmanFord SSSP (run twice on evolving inputs)",
)
def bellman_ford(
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

    def make_step(src_e, dst_e, w_e):
        def step(state, frontier_mask):
            (dist,) = state
            best = edge_map_min(src_e, dst_e, dist[src_e] + w_e, frontier_mask, n, INF)
            improved = (best < dist) & present
            new_dist = torch.where(improved, best, dist)
            return (new_dist,), improved, ~improved.any()

        return step

    steps = {
        d: make_step(*edge_endpoints(graph, d, dev)) for d in step_directions(direction)
    }

    dist0 = torch.full((n,), INF, dtype=torch.float32, device=dev)
    dist0[root] = 0.0
    init_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    init_mask[root] = True

    return run_iterations(
        name="bellmanford",
        graph=graph,
        init_state=(dist0,),
        init_frontier_mask=init_mask,
        max_iters=max_iters,
        extract_values=lambda s: s[0],
        steps=steps,
        direction=direction,
    )
