"""Graph substrate: CSR graphs, the seeded synthetic generators, the
§VI evolving pair and the METIS stand-in partitioner (ported from
``repro.graphs``)."""
from repro_torch.graphs.csr import CSRGraph, build_csr, from_edges
from repro_torch.graphs.evolve import EvolvingGraphPair, make_evolving_pair
from repro_torch.graphs.generators import (
    DATASETS,
    make_dataset,
    powerlaw_graph,
    rmat_graph,
    road_graph,
)
from repro_torch.graphs.partition import bfs_reorder, partition_contiguous

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
    "partition_contiguous",
    "bfs_reorder",
]
