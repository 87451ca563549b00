"""Cache-hierarchy configurations (paper Table VI + scaled variant).

The paper simulates: L1D 64KB/8-way 4cyc, L2 256KB/8-way 12cyc (next-line
prefetcher), LLC 8MB/16-way 42cyc, DDR4-2400 1ch (~tRCD+tCL ≈ 34 DRAM cycles
≈ 170+ core cycles with queueing).

``SCALED`` divides capacities by 16 (same associativity/latency) to pair
with the 1/32-scale synthetic graphs so miss ratios land in the paper's
regime; EXPERIMENTS.md §1 reports the calibration.
"""
from __future__ import annotations

import dataclasses

BLOCK_BITS = 6


@dataclasses.dataclass(frozen=True)
class CacheLevelConfig:
    size_bytes: int
    ways: int
    latency: int  # cycles
    mshr: int

    @property
    def lines(self) -> int:
        return self.size_bytes >> BLOCK_BITS

    @property
    def sets(self) -> int:
        s = self.lines // self.ways
        assert s & (s - 1) == 0, f"sets must be a power of two, got {s}"
        return s


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    l1: CacheLevelConfig
    l2: CacheLevelConfig
    llc: CacheLevelConfig
    dram_latency: int  # cycles, loaded latency incl. queueing
    # Prefetch in-flight window measured in *accesses*: a prefetch issued at
    # access t is resident only after t + pf_fill_window accesses (used for
    # late-prefetch classification).
    pf_fill_window: int = 40
    name: str = "hierarchy"


PAPER = HierarchyConfig(
    l1=CacheLevelConfig(64 * 1024, 8, 4, 8),
    l2=CacheLevelConfig(256 * 1024, 8, 12, 16),
    llc=CacheLevelConfig(8 * 1024 * 1024, 16, 42, 128),
    dram_latency=170,
    name="table6",
)

# Pairs with the 1/8-scale graphs: L1/L2 scaled 1/8 (keeps >=16 sets so
# conflict behavior stays sane), LLC 1/16 so footprint/LLC lands at the
# paper's ~5-10x ratio (EXPERIMENTS.md §1 records measured ratios).
SCALED = HierarchyConfig(
    l1=CacheLevelConfig(8 * 1024, 8, 4, 8),
    l2=CacheLevelConfig(32 * 1024, 8, 12, 16),
    llc=CacheLevelConfig(256 * 1024, 16, 42, 128),
    dram_latency=170,
    pf_fill_window=30,
    name="table6-scaled",
)
