"""Graph substrate: CSR graphs and the seeded synthetic generators (ported
from ``repro.graphs``; the evolving-graph dynamics and partitioning come
with the two-run kernels)."""
from repro_torch.graphs.csr import CSRGraph, build_csr, from_edges
from repro_torch.graphs.generators import (
    DATASETS,
    make_dataset,
    powerlaw_graph,
    rmat_graph,
    road_graph,
)

__all__ = [
    "CSRGraph",
    "build_csr",
    "from_edges",
    "rmat_graph",
    "powerlaw_graph",
    "road_graph",
    "make_dataset",
    "DATASETS",
]
