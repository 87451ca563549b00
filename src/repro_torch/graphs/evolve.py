"""Evolving-graph dynamics following the paper's Section VI protocol
(ported from ``repro.graphs.evolve``).

"these kernels are simulated twice with two different inputs ... For the
first time, 80% of the vertices are randomly selected; for the second time,
10% of vertices from the first input graph are randomly deleted and 10% of
vertices from the original input are added."

Vertex ids are PRESERVED across the two runs (the property/target arrays are
indexed by original vertex id), which is what makes the access-to-miss
correlations recorded on run-1 partially valid on run-2 — the effect AMC
exploits.  ``induced_subgraph`` (in :mod:`repro_torch.graphs.csr`) therefore
keeps the original id space and masks vertices instead of compacting ids.

The pair is the E=2 case of the snapshot sequence under the §VI
``UniformChurn(init_frac=0.8, del_frac=0.10, add_frac=0.10)`` model, with
the JAX package's rng draws in the same order: masks and CSR arrays are
identical to ``repro.graphs.evolve.make_evolving_pair``'s.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.csr import CSRGraph, induced_subgraph  # noqa: F401  (re-export)


@dataclasses.dataclass(frozen=True)
class EvolvingGraphPair:
    base: CSRGraph  # original full graph
    run1: CSRGraph  # 80% induced subgraph
    run2: CSRGraph  # run1 - 10% + 10% fresh
    mask1: np.ndarray
    mask2: np.ndarray

    @property
    def vertex_overlap(self) -> float:
        """Fraction of run-1's active vertices still present in run-2."""
        both = (self.mask1 & self.mask2).sum()
        return float(both / max(self.mask1.sum(), 1))


def make_evolving_pair(g: CSRGraph, seed: int = 0) -> EvolvingGraphPair:
    """§VI two-run protocol — the E=2 epoch sequence under uniform churn."""
    # Imported here: repro_torch.stream builds on repro_torch.graphs, not
    # the reverse.
    from repro_torch.stream.snapshots import snapshot_sequence
    from repro_torch.stream.updates import UniformChurn

    seq = snapshot_sequence(g, UniformChurn(), epochs=2, seed=seed)
    return EvolvingGraphPair(
        base=g,
        run1=dataclasses.replace(seq.graphs[0], name=g.name + "@run1"),
        run2=dataclasses.replace(seq.graphs[1], name=g.name + "@run2"),
        mask1=seq.masks[0],
        mask2=seq.masks[1],
    )
