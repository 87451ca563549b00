"""AMC's lightweight programming interface (paper §IV, Table V).

The five calls map 1:1 onto the paper's API. In hardware these set
architectural registers; here they configure an :class:`AMCSession` that the
workload driver consults — the same separation as the paper: the *software*
only identifies two data structures and the iteration boundary, everything
else is "hardware" (the trace-driven pipeline in
:mod:`repro_torch.core.amc.prefetcher`).

    sess = AMCSession()
    sess.init(asid=0)                      # AMC.init()
    sess.addr_t_base(t_base, t_size)       # AMC.AddrTBase(addr, size)
    sess.addr_f_base(f_base, f_size)       # AMC.AddrFBase(addr, size)
    ... per iteration ...
    sess.update()                          # AMC.update()  (role swap)
    sess.end()                             # AMC.end()

The evolving-graph drivers (examples/, benchmarks/) call these around the
Ligra loops exactly as the paper's Algorithm 1 does for PGD.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class _ArchRegisters:
    """The architectural state of §IV-A."""

    asid: Optional[int] = None
    target_base: Optional[int] = None
    target_size: int = 0
    target_elem_size: int = 8
    frontier_base: Optional[int] = None
    frontier_size: int = 0
    frontier_elem_size: int = 1
    prefetch_phase: bool = False  # set after the initial iteration
    target_access_count: int = 0
    miss_count: int = 0


class AMCSession:
    """Host-side owner of AMC architectural registers + metadata spaces."""

    def __init__(self):
        self.regs = _ArchRegisters()
        self.active = False
        self.iteration = 0
        self.graph_version = 0
        self._ended = False

    # --- Table V calls ---

    def init(self, asid: int = 0) -> None:
        """Set ASID for permission checks, allocate AMC storage."""
        self.regs = _ArchRegisters(asid=asid)
        self.active = True
        self._ended = False
        self.iteration = 0
        self.graph_version = 0

    def addr_t_base(self, addr: int, size: int, elem_size: int = 8) -> None:
        assert self.active, "AMC.init() first"
        if elem_size < 1:
            raise ValueError(f"target elem_size must be >= 1, got {elem_size}")
        # Validate against the declared frontier range BEFORE committing, so
        # a rejected call leaves the session's registers untouched.
        if self.regs.frontier_base is not None:
            self._validate_elem_ratio(int(elem_size), self.regs.frontier_elem_size)
        self.regs.target_base = int(addr)
        self.regs.target_size = int(size)
        self.regs.target_elem_size = int(elem_size)

    def addr_f_base(self, addr: int, size: int, elem_size: int = 1) -> None:
        assert self.active, "AMC.init() first"
        if elem_size < 1:
            raise ValueError(f"frontier elem_size must be >= 1, got {elem_size}")
        if self.regs.target_base is not None:
            self._validate_elem_ratio(self.regs.target_elem_size, int(elem_size))
        self.regs.frontier_base = int(addr)
        self.regs.frontier_size = int(size)
        self.regs.frontier_elem_size = int(elem_size)

    @staticmethod
    def _validate_elem_ratio(target_elem_size: int, frontier_elem_size: int) -> None:
        """Once both ranges are declared, the §V-C2 address calculation
        scales frontier deltas by target_elem_size // frontier_elem_size —
        reject non-divisible sizes up front instead of truncating silently."""
        if target_elem_size % frontier_elem_size:
            raise ValueError(
                f"AMC address calculation requires target_elem_size "
                f"({target_elem_size}) to be an integer multiple of "
                f"frontier_elem_size ({frontier_elem_size}); the §V-C2 "
                "scaling target_delta = frontier_delta * "
                "(target_elem_size // frontier_elem_size) would silently "
                "truncate"
            )

    def update(self) -> None:
        """Iteration boundary: enable prefetching, swap metadata roles,
        reset the target access counter."""
        assert self.active
        self.regs.prefetch_phase = True
        self.regs.target_access_count = 0
        self.regs.miss_count = 0
        self.iteration += 1

    def new_graph_version(self) -> int:
        """Epoch boundary of an *evolving stream*: the software announces
        that the input graph advanced to its next version (a batch of edge
        updates was applied).

        Distinct from :meth:`update` — the iteration boundary within one
        graph version.  Correlation metadata survives the boundary per the
        host's table lifecycle policy (``repro_torch.stream.lifecycle``); the
        declared TARGET/frontier ranges must remain valid, which the
        stream protocol guarantees by laying out all epochs in one shared
        address space (``repro_torch.stream.protocol``).  Returns the new
        version number.
        """
        assert self.active, "AMC.init() first"
        self.graph_version += 1
        return self.graph_version

    def end(self) -> None:
        """Free AMC storage, reset registers, invalidate AMC Cache."""
        self.active = False
        self._ended = True
        self.regs = _ArchRegisters()

    # --- helpers used by the tracer/driver ---

    def in_target_range(self, addr) -> bool:
        r = self.regs
        if r.target_base is None:
            return False
        return r.target_base <= addr < r.target_base + r.target_size

    def in_frontier_range(self, addr) -> bool:
        r = self.regs
        if r.frontier_base is None:
            return False
        return r.frontier_base <= addr < r.frontier_base + r.frontier_size

    def address_calculation(self, frontier_addr: int) -> int:
        """§V-C2: target_delta = frontier_delta * (target_size/frontier_size)."""
        r = self.regs
        ratio, rem = divmod(r.target_elem_size, r.frontier_elem_size)
        if rem:
            # Registers mutated after the AddrXBase validation — same hazard.
            raise ValueError(
                f"non-divisible element sizes ({r.target_elem_size} vs "
                f"{r.frontier_elem_size}): §V-C2 scaling would truncate"
            )
        fdelta = frontier_addr - r.frontier_base
        return r.target_base + fdelta * ratio

    @property
    def configured(self) -> bool:
        return (
            self.active
            and self.regs.target_base is not None
            and self.regs.frontier_base is not None
        )
