"""K2: fused multi-level LRU hierarchy pass (CUDA kernel + plain PyTorch version).

Replaces the Pallas kernel ``repro/kernels/cache_sim/fused_sim.py``
``fused_levels_pallas``.  With ``G = min(sets)`` groups, group ``g`` owns
``R_i = sets_i / G`` whole sets at level ``i``; its per-level state row is
``R_i * ways_i`` lanes (relative set major, the layout of
:func:`repro_torch.memsim.fused.state_to_groups`).  The input is ragged:
the group-sorted, run-collapsed stream plus per-row offsets, one row per
(stream, group).  On a CUDA tensor :func:`fused_levels` launches
``csrc/fused_levels.cu`` (one warp per row, longest rows first, every
level's ways looked up at once; the row's state in shared memory, or in
global memory when it does not fit, see :func:`fused_levels_route`); on a
CPU tensor it runs :func:`fused_levels_plain`, which advances every row one
access per step over the padded matrix, as
``repro/memsim/fused.py::_fused_scan`` does.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels.build import load, ptr, stream_ptr
from repro_torch.kernels.cache_sim.cache_sim import MAX_WAYS, ragged_to_padded

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_levels.cu"
MAX_LEVELS = 4
# The most dynamic shared memory a block of the H100 may opt in to (227 KB):
# a row's state larger than this walks global memory.
SMEM_BUDGET = 232_448
_INT32_MIN = torch.iinfo(torch.int32).min


def _geometry(levels: Sequence[Tuple[int, int]]):
    """``(lg, rmask, ways, lanes)`` per-level table of the kernel."""
    groups = min(s for s, _ in levels)
    rmask = [s // groups - 1 for s, _ in levels]
    ways = [w for _, w in levels]
    lanes = [(s // groups) * w for s, w in levels]
    return groups.bit_length() - 1, rmask, ways, lanes


def _check(blocks, offsets, levels, tags, age):
    k = len(levels)
    if not 1 <= k <= MAX_LEVELS:
        raise ValueError(f"fused_levels: 1..{MAX_LEVELS} levels, got {k}")
    if len(tags) != k or len(age) != k:
        raise ValueError("fused_levels: one tags and one age tensor per level")
    rows = offsets.shape[0] - 1
    _, _, ways, lanes = _geometry(levels)
    for i in range(k):
        if not 1 <= ways[i] <= MAX_WAYS:
            raise ValueError(f"fused_levels: ways must be in [1, {MAX_WAYS}]")
        for t in (tags[i], age[i]):
            if t.dtype != torch.int32 or t.device != blocks.device or not t.is_contiguous():
                raise ValueError("fused_levels: states must be contiguous int32 beside blocks")
            if t.shape != (rows, lanes[i]):
                raise ValueError(
                    f"fused_levels: level {i} state {tuple(t.shape)} != {(rows, lanes[i])}"
                )
    if blocks.dtype != torch.int32 or blocks.dim() != 1 or not blocks.is_contiguous():
        raise ValueError("fused_levels: blocks must be a contiguous (N,) int32 tensor")
    if offsets.dtype != torch.int64 or offsets.device != blocks.device:
        raise ValueError("fused_levels: offsets must be int64 beside blocks")


def fused_levels_route(levels) -> str:
    """``"shared"`` when a row's state, ``sum(R_i * ways_i)`` (tag, age)
    pairs, fits a block's shared memory, else ``"global"``."""
    lanes = _geometry(tuple((int(s), int(w)) for s, w in levels))[3]
    return "shared" if sum(lanes) * 8 <= SMEM_BUDGET else "global"


@functools.cache
def _launch_fn():
    """The kernel's C entry point, bound once per process."""
    fn = load(SOURCE).fused_levels_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
        + [ctypes.c_int] + [ctypes.c_void_p] * 2
    )
    fn.restype = ctypes.c_int
    return fn


def fused_levels(blocks, offsets, levels, tags: List, age: List):
    """Hit level of every access of a ragged group-sorted stream.

    ``blocks`` (N,) int32 holds row ``r``'s accesses at ``[offsets[r],
    offsets[r + 1])``; ``tags[i]`` / ``age[i]`` (rows, R_i * ways_i) int32
    are level ``i``'s carried state per row.  Returns ``(lvl, tags_out,
    age_out)``: ``lvl`` (N,) int8 (``i`` = hit at level ``i``, ``k`` =
    missed everywhere) and the final raw per-level states.
    """
    levels = tuple((int(s), int(w)) for s, w in levels)
    _check(blocks, offsets, levels, tags, age)
    if blocks.device.type == "cpu":
        return fused_levels_plain(blocks, offsets, levels, tags, age)
    fn = _launch_fn()
    k = len(levels)
    lg, rmask, ways, lanes = _geometry(levels)
    route = fused_levels_route(levels)
    rows = offsets.shape[0] - 1
    # longest rows first: with more rows than fit the card at once, the
    # longest chains start in the first wave
    order = torch.argsort(offsets[1:] - offsets[:-1], descending=True, stable=True)
    order = order.to(torch.int32)
    tags_out = [torch.empty_like(t) for t in tags]  # the kernel writes the final state
    age_out = [torch.empty_like(a) for a in age]
    lvl = torch.empty(blocks.shape[0], dtype=torch.int8, device=blocks.device)
    ints = ctypes.c_int * k
    ptrs = ctypes.c_void_p * k
    rc = fn(
        ptr(blocks), ptr(offsets), ptr(order), rows, k, lg,
        ints(*rmask), ints(*ways), ints(*lanes),
        ptrs(*(t.data_ptr() for t in tags)), ptrs(*(a.data_ptr() for a in age)),
        ptrs(*(t.data_ptr() for t in tags_out)), ptrs(*(a.data_ptr() for a in age_out)),
        int(route == "shared"), ptr(lvl), stream_ptr(blocks.device),
    )
    if rc:
        raise RuntimeError(f"fused_levels launch failed with CUDA error {rc}")
    fused_levels.launches += 1
    fused_levels.routes[route] += 1
    return lvl, tags_out, age_out


fused_levels.launches = 0
fused_levels.routes = {"shared": 0, "global": 0}  # launches by route


def fused_levels_plain(blocks, offsets, levels, tags: List, age: List):
    """Plain PyTorch version of :func:`fused_levels`: every row advances
    one access per step over the padded matrix.  At each level the
    accessed set's lanes are gathered, the fused victim select picks the
    way, and the update is masked by ``alive`` (the access missed every
    level above; pads are never alive).  Same outputs as the kernel."""
    levels = tuple((int(s), int(w)) for s, w in levels)
    k = len(levels)
    lg, rmask, ways, _ = _geometry(levels)
    padded, col, row = ragged_to_padded(blocks, offsets)
    tags = [t.clone() for t in tags]
    age = [a.clone() for a in age]
    dev = blocks.device
    lvl_mat = torch.full(padded.shape, k, dtype=torch.int8, device=dev)
    for t in range(padded.shape[0]):
        b = padded[t]
        alive = b >= 0
        lvl = lvl_mat[t]
        for i in range(k):
            lanes = torch.arange(ways[i], device=dev)
            idx = (((b >> lg) & rmask[i]) * ways[i])[:, None] + lanes
            row_t = tags[i].gather(1, idx)
            row_a = age[i].gather(1, idx)
            hitv = row_t == b[:, None]
            hit = hitv.any(dim=1)
            way = torch.where(hitv, _INT32_MIN, row_a).argmin(dim=1)
            onehot = (way[:, None] == lanes) & alive[:, None]
            tags[i].scatter_(1, idx, torch.where(onehot, b[:, None], row_t))
            age[i].scatter_(1, idx, torch.where(onehot, t + 1, row_a))
            lvl[alive & hit] = i
            alive = alive & ~hit
    return lvl_mat[col, row], tags, age


__all__ = [
    "MAX_LEVELS",
    "SMEM_BUDGET",
    "SOURCE",
    "fused_levels",
    "fused_levels_plain",
    "fused_levels_route",
]
