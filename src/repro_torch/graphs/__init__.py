"""Graph substrate: CSR graphs, the seeded synthetic generators and the
§VI evolving pair (ported from ``repro.graphs``; partitioning comes with
the sharded execution engine)."""
from repro_torch.graphs.csr import CSRGraph, build_csr, from_edges
from repro_torch.graphs.evolve import EvolvingGraphPair, make_evolving_pair
from repro_torch.graphs.generators import (
    DATASETS,
    make_dataset,
    powerlaw_graph,
    rmat_graph,
    road_graph,
)

__all__ = [
    "CSRGraph",
    "EvolvingGraphPair",
    "build_csr",
    "from_edges",
    "rmat_graph",
    "powerlaw_graph",
    "road_graph",
    "make_dataset",
    "make_evolving_pair",
    "DATASETS",
]
