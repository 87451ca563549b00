"""Connected Components via label propagation (Ligra CC).

Every vertex starts in its own component; active vertices push their label,
destinations keep the min, and changed vertices stay active. On directed
input the graph is symmetrized (CC is an undirected notion), matching
Ligra's behavior.  Pull traversal reduces the same min over in-edges of the
symmetrized graph — labels are bit-identical (min is order-free).

The step runs on the device.  Labels stay float32 with ``big = n + 1``
where a vertex is absent, as in the JAX package, and the min goes through
``scatter_reduce`` ``amin`` (:func:`~repro_torch.apps.ligra.edge_map_min`),
so labels and frontiers equal the reference's in every direction.
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
from repro_torch.apps.registry import register_kernel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.csr import CSRGraph, symmetrize


@register_kernel(
    "cc",
    epoch_protocol="per_iteration",
    directions=("push", "pull", "auto"),
    description="Connected Components (label propagation; Ligra)",
)
def connected_components(
    graph: CSRGraph,
    max_iters: int = 100,
    present_mask: np.ndarray | None = None,
    direction: str = "push",
    device: DeviceLike = None,
) -> AppRun:
    dev = resolve_device(device)
    und = symmetrize(graph)
    n = und.num_vertices

    present = torch.from_numpy(
        np.asarray(present_mask if present_mask is not None else und.degrees > 0)
    ).to(dev)
    big = float(n + 1)

    def make_step(src_e, dst_e, _w):
        def step(state, frontier_mask):
            (labels,) = state
            incoming = edge_map_min(src_e, dst_e, labels[src_e], frontier_mask, n, big)
            new_labels = torch.minimum(labels, incoming)
            changed = (new_labels < labels) & present
            return (new_labels,), changed, ~changed.any()

        return step

    steps = {
        d: make_step(*edge_endpoints(und, d, dev)) for d in step_directions(direction)
    }

    labels0 = torch.where(
        present, torch.arange(n, dtype=torch.float32, device=dev), big
    )

    return run_iterations(
        name="cc",
        graph=und,
        init_state=(labels0,),
        init_frontier_mask=present,
        max_iters=max_iters,
        extract_values=lambda s: s[0],
        steps=steps,
        direction=direction,
    )
