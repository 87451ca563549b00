"""Baseline prefetchers evaluated against AMC (paper Table I / §VII).

All are L2 prefetchers trained per their declared ``trains_on`` stream —
the spatial prefetchers (VLDP, Bingo) on the L2 access stream (= L1
misses), the temporal ones (ISB, MISB, Domino) and RnR on L2 misses — as in
the paper.  PC localization uses the accessing array id, the paper's Table
II model.  Every one of the JAX package's prefetchers is ported: the seven
Table I baselines (``vldp``, ``bingo``, ``isb``, ``misb``, ``rnr``,
``domino``, ``prodigy``), ``nextline2`` and the ``ideal`` bound.  They are
host numpy, as in the JAX package, and self-register at definition site
via ``@register_prefetcher`` (:mod:`repro_torch.core.registry`).
"""
from repro_torch.core.prefetchers.simple import nextline_extra, droplet_model, ideal_l2
from repro_torch.core.prefetchers.temporal import isb, misb, domino
from repro_torch.core.prefetchers.spatial import vldp, bingo
from repro_torch.core.prefetchers.rnr import rnr

# Registers "amc" (the modules above register the seven baselines + extras).
import repro_torch.core.amc.prefetcher  # noqa: F401

# The seven Table I baselines, in the paper's presentation order.
BASELINE_NAMES = ("vldp", "bingo", "isb", "misb", "rnr", "domino", "prodigy")

__all__ = [
    "nextline_extra",
    "droplet_model",
    "ideal_l2",
    "isb",
    "misb",
    "domino",
    "vldp",
    "bingo",
    "rnr",
    "BASELINE_NAMES",
]
