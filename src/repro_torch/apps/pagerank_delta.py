"""PageRankDelta (PGD) — Algorithm 1 of the paper (from Ligra [53]).

Early-convergence PageRank: only vertices whose delta moved by more than a
threshold stay active, so the frontier shrinks and shifts across iterations
— the "non-repetitive irregular" pattern that defeats record-once
prefetchers (RnR) and that AMC's per-iteration re-recording tracks.

Registered as ``pgd`` (push) with a ``pgd_pull`` variant that traverses
in-edges dense-style every iteration.  The step runs on the device in
float32 with the JAX package's operation order; the neighbor sum adds each
destination's contributions in edge order (the ordered segment sum), so
frontiers equal the reference's.  Only the convergence ``error`` is a
reduction in another order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.ligra import AppRun, edge_endpoints, run_iterations, step_directions
from repro_torch.apps.registry import register_kernel, register_kernel_variant
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.csr import CSRGraph
from repro_torch.kernels.segment_sum.segment_sum import segment_plan, segment_sum


@register_kernel(
    "pgd",
    epoch_protocol="per_iteration",
    directions=("push", "pull", "auto"),
    description="PageRankDelta (early-convergence iterative; Ligra)",
)
def pagerank_delta(
    graph: CSRGraph,
    alpha: float = 0.85,
    delta_threshold: float = 0.01,  # δ: active iff |Δ[v]| > δ·PR[v] (Ligra)
    epsilon: float = 1e-6,
    max_iters: int = 30,
    present_mask: np.ndarray | None = None,
    direction: str = "push",
    device: DeviceLike = None,
) -> AppRun:
    dev = resolve_device(device)
    n = graph.num_vertices
    # Contributions normalize by the *out*-degree of the source regardless
    # of traversal direction.
    deg = torch.from_numpy(graph.degrees).to(dev).to(torch.float32).clamp_min(1.0)
    present = torch.from_numpy(
        np.asarray(present_mask if present_mask is not None else graph.degrees > 0)
    ).to(dev)
    n_present = present.to(torch.float32).sum().clamp_min(1.0)

    def make_step(src_e, dst_e, _w):
        plan = segment_plan(dst_e.cpu().numpy(), n, dev)

        def step(state, frontier_mask):
            delta, pr = state
            contrib = torch.where(frontier_mask[src_e], delta[src_e] / deg[src_e], 0.0)
            ngh_sum = segment_sum(contrib, plan)
            touched = ngh_sum != 0.0
            new_delta = torch.where(touched, alpha * ngh_sum, 0.0)
            new_pr = pr + new_delta
            # Ligra-style early convergence: a vertex stays active only while
            # its rank still moves by more than a δ fraction of its rank.
            new_mask = (
                touched
                & (new_delta.abs() > delta_threshold * new_pr.abs())
                & present
            )
            error = ngh_sum.abs().sum()
            return (new_delta, new_pr), new_mask, error < epsilon

        return step

    steps = {
        d: make_step(*edge_endpoints(graph, d, dev)) for d in step_directions(direction)
    }

    delta0 = torch.where(present, 1.0 / n_present, 0.0).to(torch.float32)
    pr0 = torch.zeros(n, dtype=torch.float32, device=dev) + delta0

    return run_iterations(
        name="pgd",
        graph=graph,
        init_state=(delta0, pr0),
        init_frontier_mask=present,
        max_iters=max_iters,
        extract_values=lambda s: s[1],
        steps=steps,
        direction=direction,
    )


register_kernel_variant(
    "pgd_pull",
    base="pgd",
    direction="pull",
    description="PageRankDelta, dense pull traversal every iteration",
)
