"""Baseline prefetchers evaluated against AMC (paper Table I / §VII).

Ported so far: the spatial prefetchers VLDP and Bingo
(:mod:`repro_torch.core.prefetchers.spatial`), trained on the L2 access
stream (= L1 misses).  The temporal ones, RnR and the simple models come in
a later slice.  Every prefetcher self-registers at definition site via
``@register_prefetcher`` (:mod:`repro_torch.core.registry`).
"""
from repro_torch.core.prefetchers.spatial import vldp, bingo

# Registers "amc".
import repro_torch.core.amc.prefetcher  # noqa: F401

__all__ = ["vldp", "bingo"]
