"""Evolving-graph applications (Ligra-style, PyTorch) + memory-trace generation.

Kernels register declaratively (:mod:`repro_torch.apps.registry`): the
paper's four, ``pgd`` (PageRankDelta) with its ``pgd_pull`` variant,
``cc`` (Connected Components), ``bfs`` with its ``bfs_do`` variant and
``bellmanford``, all ported.
Kernels are written against the ``edge_map`` / ``run_iterations``
primitives in :mod:`repro_torch.apps.ligra` and return an
:class:`~repro_torch.apps.ligra.AppRun`, which the tracer
(:mod:`repro_torch.apps.trace`, numpy) turns into access streams.
"""
from repro_torch.apps.ligra import AppRun, edge_map_min, edge_map_sum
from repro_torch.apps.registry import (
    KernelSpec,
    get_kernel,
    has_kernel,
    kernel_traits,
    list_kernels,
    register_kernel,
    register_kernel_variant,
)
from repro_torch.apps.pagerank_delta import pagerank_delta
from repro_torch.apps.connected_components import connected_components
from repro_torch.apps.bfs import bfs, pick_root
from repro_torch.apps.bellman_ford import bellman_ford
from repro_torch.apps.trace import (
    ARRAYS,
    IterationTrace,
    RunTrace,
    TraceConfig,
    trace_app_run,
    trace_run,
)

__all__ = [
    "AppRun",
    "KernelSpec",
    "edge_map_sum",
    "edge_map_min",
    "pagerank_delta",
    "connected_components",
    "bfs",
    "bellman_ford",
    "pick_root",
    "get_kernel",
    "has_kernel",
    "kernel_traits",
    "list_kernels",
    "register_kernel",
    "register_kernel_variant",
    "TraceConfig",
    "IterationTrace",
    "RunTrace",
    "trace_app_run",
    "trace_run",
    "ARRAYS",
]
