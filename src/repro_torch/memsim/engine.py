"""Set-parallel cache simulation engine (PyTorch port of ``repro.memsim.engine``).

Two exact equivalences turn the serial one-access-per-step simulator into
a batch of short, independent per-set simulations:

1. **Set independence.** Replacement state never crosses sets, so a stable
   group-by sort of the stream by set index ``b & (sets - 1)`` yields
   ``sets`` independent substreams whose hit masks scatter back through the
   sort order into the full-stream mask.
2. **True LRU per set.** Each substream runs its own ``ways``-lane LRU
   machine; ages are positions within the substream, so only their order
   matters.

The grouped stream is *ragged*: the set-sorted stream plus per-set
offsets.  On the GPU, kernel K1 (:func:`repro_torch.kernels.cache_sim.ops.lru_hits`)
runs one thread per set over it; with a leading stream axis, one launch
serves a whole family of streams (:func:`cache_pass_batch`).  On a CPU
device the kernel's plain PyTorch version runs instead, padding the rows,
and set-skewed streams (whose padded matrix would dwarf the stream) take
the serial reference, as in the JAX package.  The GPU path has no skew
guard: the ragged kernel does no pad work.

Engines (``REPRO_TORCH_CACHE_ENGINE``, :func:`set_engine`, :func:`use_engine`):

- ``fused`` (default): whole-hierarchy demand passes run on kernel K2
  (:mod:`repro_torch.memsim.fused`); scoring families run as one K1 launch
  per level; single-level passes run K1.
- ``set_parallel``: every level is its own K1 pass.
- ``reference``: the serial host loop of :mod:`repro_torch.memsim.scan_cache`,
  the oracle; it runs only when selected.

**Carried state.** ``cache_pass(..., state=..., return_state=True)``
threads a :class:`CacheState` through chunked passes.  The returned state
is *canonical* (per set, empty ways first in way order, then filled ways
LRU→MRU, aged ``-ways..-1``), so it is engine-independent and equal to the
JAX package's for the same stream prefix.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.cache_sim.ops import lru_hits
from repro_torch.memsim import scan_cache

ENGINES = ("fused", "set_parallel", "reference")
ENGINE_ENV = "REPRO_TORCH_CACHE_ENGINE"
DEFAULT_ENGINE = "fused"

_override: Optional[str] = None


def _check(name: str) -> str:
    if name not in ENGINES:
        raise ValueError(f"unknown cache engine {name!r}; choose from {ENGINES}")
    return name


def current_engine() -> str:
    """The active engine: ``set_engine`` override > env var > default."""
    if _override is not None:
        return _override
    env = os.environ.get(ENGINE_ENV)
    return _check(env) if env is not None else DEFAULT_ENGINE


def set_engine(name: Optional[str]) -> None:
    """Select the cache engine process-wide (``None`` restores env/default)."""
    global _override
    _override = _check(name) if name is not None else None


@contextlib.contextmanager
def use_engine(name: str) -> Iterator[None]:
    """Run the enclosed block under a specific cache engine."""
    global _override
    prev, _override = _override, _check(name)
    try:
        yield
    finally:
        _override = prev


@dataclasses.dataclass
class CacheState:
    """Canonical tag/LRU carry of one cache level between chunked passes.

    ``tags`` and ``age`` are ``(sets, ways)`` int32 tensors (tag -1 = empty
    way) on the device of the pass that produced them, ``age`` in the
    canonical form of :func:`canonicalize_state`.
    """

    tags: torch.Tensor
    age: torch.Tensor

    @property
    def sets(self) -> int:
        return self.tags.shape[0]

    @property
    def ways(self) -> int:
        return self.tags.shape[1]

    def to(self, device) -> "CacheState":
        return CacheState(self.tags.to(device), self.age.to(device))


def init_state(sets: int, ways: int, device: DeviceLike = None) -> CacheState:
    """Canonical all-empty state (what a cold pass starts from)."""
    dev = resolve_device(device)
    tags = torch.full((sets, ways), -1, dtype=torch.int32, device=dev)
    age = torch.arange(-ways, 0, dtype=torch.int32, device=dev).repeat(sets, 1)
    return CacheState(tags, age)


def canonicalize_state(tags: torch.Tensor, age: torch.Tensor) -> CacheState:
    """Re-age raw tag/age arrays into the canonical carry form.

    Per set, ways rank empties first (in way order), then filled ways by
    ascending raw age (LRU → MRU), and take ages ``rank - ways``.  Only the
    per-set order of raw ages matters, so engines with different age
    counters canonicalize to the same state.
    """
    tags = tags.to(torch.int32)
    ways = tags.shape[1]
    key = torch.where(
        tags == -1, torch.iinfo(torch.int64).min, age.to(torch.int64)
    )
    order = torch.argsort(key, dim=1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(
        1, order, torch.arange(ways, device=tags.device).expand_as(order).contiguous()
    )
    return CacheState(tags.clone(), (rank - ways).to(torch.int32))


def _block_array(blocks) -> np.ndarray:
    blocks = np.asarray(blocks)
    # An id >= 2**31 would wrap negative in int32 and alias the -1
    # empty-way sentinel.
    if blocks.max(initial=0) >= 2**31:
        raise ValueError("block ids must fit in int32")
    return blocks


def group_by_set(blocks: np.ndarray, sets: int):
    """Ragged group-by-set of one stream.

    Returns ``(sorted_blocks, order, counts)``: ``sorted_blocks`` (N,)
    int32 is the stream stably sorted by set (each set's substream in
    stream order), ``order`` the sort permutation (scatter per-access
    results back with ``out[order] = res``), and ``counts`` (sets,) the
    substream lengths.
    """
    b32 = _block_array(blocks).astype(np.int32)
    if sets > 1 << 16:
        raise ValueError("set index must fit the uint16 radix-sort key")
    s = b32 & np.int32(sets - 1)
    # uint16 sort key routes numpy's stable argsort to its O(N) radix path.
    order = np.argsort(s.astype(np.uint16), kind="stable")
    return b32[order], order, np.bincount(s, minlength=sets)


def _bucket_len(n: int) -> int:
    """Pow2 bucket (min 128) of a padded substream length — the JAX
    package's padded size, kept so the CPU skew guard decides alike."""
    return max(128, 1 << (n - 1).bit_length())


# CPU skew guard (plain version only): beyond _PAD_FACTOR x N padded cells
# (absolute floor _PAD_FLOOR_CELLS) the serial reference wins.
_PAD_FACTOR = 4
_PAD_FLOOR_CELLS = 1 << 22


def _pad_skewed(blocks: np.ndarray, sets: int) -> bool:
    counts = np.bincount(
        np.asarray(blocks, dtype=np.int64) & (sets - 1), minlength=sets
    )
    cells = _bucket_len(int(counts.max(initial=0))) * sets
    return cells > max(_PAD_FACTOR * len(blocks), _PAD_FLOOR_CELLS)


def ragged_offsets(counts: Sequence[np.ndarray]) -> np.ndarray:
    """Row offsets (rows + 1,) int64 of concatenated per-stream row counts."""
    flat = np.concatenate([np.asarray(c, dtype=np.int64) for c in counts])
    offsets = np.zeros(len(flat) + 1, dtype=np.int64)
    np.cumsum(flat, out=offsets[1:])
    return offsets


def _lru_family(streams, sets, ways, states, device, return_state):
    """One K1 launch over a family of streams (stream axis), each from its
    own carried state.  Returns hit masks and, optionally, canonical
    final states."""
    grouped = [group_by_set(s, sets) for s in streams]
    blocks = torch.from_numpy(
        np.concatenate([g[0] for g in grouped]) if grouped else np.zeros(0, np.int32)
    ).to(device)
    offsets = torch.from_numpy(ragged_offsets([g[2] for g in grouped])).to(device)
    tags0 = torch.cat([st.tags.to(device) for st in states]).contiguous()
    age0 = torch.cat([st.age.to(device) for st in states]).contiguous()
    hits, tags1, age1 = lru_hits(blocks, offsets, tags0, age0)
    hits = hits.cpu().numpy().astype(bool)
    outs, base = [], 0
    for s, (_, order, _) in zip(streams, grouped):
        out = np.zeros(len(s), dtype=bool)
        out[order] = hits[base : base + len(s)]
        outs.append(out)
        base += len(s)
    if not return_state:
        return outs, None
    finals = [
        canonicalize_state(tags1[i * sets : (i + 1) * sets], age1[i * sets : (i + 1) * sets])
        for i in range(len(streams))
    ]
    return outs, finals


def cache_pass_fused_select(
    blocks: np.ndarray,
    sets: int,
    ways: int,
    state: Optional[CacheState] = None,
    return_state: bool = False,
    device: DeviceLike = None,
):
    """One-level pass on kernel K1 (its plain version on a CPU device,
    where set-skewed streams take the serial reference)."""
    dev = resolve_device(device)
    blocks = _block_array(blocks)
    if dev.type == "cpu" and _pad_skewed(blocks, sets):
        return scan_cache.cache_pass(blocks, sets, ways, state, return_state, dev)
    st = state if state is not None else init_state(sets, ways, dev)
    outs, finals = _lru_family([blocks], sets, ways, [st], dev, return_state)
    return (outs[0], finals[0]) if return_state else outs[0]


def cache_pass_batch(streams, sets: int, ways: int, device: DeviceLike = None):
    """Cold-state passes of a family of streams through one level.

    On the GPU the whole family is one K1 launch (stream axis); on a CPU
    device one plain-version call pads every member to the longest row,
    unless a member is set-skewed, which loops :func:`cache_pass`.
    Returns one hit mask per stream, bit-identical to looping
    :func:`cache_pass`.
    """
    dev = resolve_device(device)
    if len(streams) == 0:
        return []
    streams = [_block_array(s) for s in streams]
    if dev.type == "cpu" and any(_pad_skewed(s, sets) for s in streams):
        return [cache_pass(s, sets, ways, device=dev) for s in streams]
    cold = init_state(sets, ways, dev)
    outs, _ = _lru_family(streams, sets, ways, [cold] * len(streams), dev, False)
    return outs


def cache_pass(
    blocks: np.ndarray,
    sets: int,
    ways: int,
    state: Optional[CacheState] = None,
    return_state: bool = False,
    device: DeviceLike = None,
):
    """Run an access stream through one cache level; returns the hit mask
    (and, with ``return_state``, the canonical final :class:`CacheState`).

    Dispatches on the active engine: ``reference`` runs the serial host
    oracle; ``fused`` and ``set_parallel`` run kernel K1.  With ``state=``
    the pass resumes from a carry and is bit-identical to one
    uninterrupted pass over the concatenated stream.
    """
    dev = resolve_device(device)
    if len(blocks) == 0:
        hits = np.zeros(0, dtype=bool)
        if not return_state:
            return hits
        st = state if state is not None else init_state(sets, ways, dev)
        return hits, CacheState(st.tags.to(dev).clone(), st.age.to(dev).clone())
    if current_engine() == "reference":
        return scan_cache.cache_pass(blocks, sets, ways, state, return_state, dev)
    return cache_pass_fused_select(blocks, sets, ways, state, return_state, dev)


__all__ = [
    "ENGINES",
    "ENGINE_ENV",
    "CacheState",
    "cache_pass",
    "cache_pass_batch",
    "cache_pass_fused_select",
    "canonicalize_state",
    "current_engine",
    "group_by_set",
    "init_state",
    "ragged_offsets",
    "set_engine",
    "use_engine",
]
