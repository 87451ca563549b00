"""Public API of the cache-simulation kernels: K1 (:func:`lru_hits`), K2
(:func:`fused_levels`), their plain PyTorch versions, and the pure-Python
oracle.  The host-side grouping that feeds them lives in
:mod:`repro_torch.memsim.engine` and :mod:`repro_torch.memsim.fused`."""
from repro_torch.kernels.cache_sim.cache_sim import SOURCE as LRU_SOURCE
from repro_torch.kernels.cache_sim.cache_sim import lru_hits, lru_hits_plain
from repro_torch.kernels.cache_sim.fused_sim import SOURCE as FUSED_SOURCE
from repro_torch.kernels.cache_sim.fused_sim import fused_levels, fused_levels_plain
from repro_torch.kernels.cache_sim.ref import lru_hits_ref

SOURCES = (LRU_SOURCE, FUSED_SOURCE)

__all__ = [
    "SOURCES",
    "fused_levels",
    "fused_levels_plain",
    "lru_hits",
    "lru_hits_plain",
    "lru_hits_ref",
]
