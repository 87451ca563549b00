"""K1: set-parallel true-LRU cache pass (CUDA kernel + plain PyTorch version).

Replaces the Pallas kernels ``repro/kernels/cache_sim/cache_sim.py``
``lru_hits`` / ``lru_hits_carry``.  The input is *ragged*: the stably
set-sorted stream plus per-row offsets, one row per (stream, set).  On a
CUDA tensor :func:`lru_hits` launches ``csrc/lru_hits.cu`` (G lanes per
(stream, set) row, G the ways rounded up to a power of two, one way per
lane; a batch of 4G accesses loaded a batch ahead into registers, hit bits
stored 4 bytes at a time); on a CPU tensor it runs :func:`lru_hits_plain`,
which pads the rows into a ``(max_len, rows)`` matrix and advances every
row one access per step, as ``repro/memsim/engine.py::_batched_pass`` does.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load, ptr, stream_ptr

SOURCE = Path(__file__).resolve().parent / "csrc" / "lru_hits.cu"
MAX_WAYS = 32
_INT32_MIN = torch.iinfo(torch.int32).min


def _check(blocks, offsets, tags, age):
    rows, ways = tags.shape
    for name, t, dt in (
        ("blocks", blocks, torch.int32),
        ("offsets", offsets, torch.int64),
        ("tags", tags, torch.int32),
        ("age", age, torch.int32),
    ):
        if t.dtype != dt:
            raise TypeError(f"lru_hits: {name} must be {dt}, got {t.dtype}")
        if t.device != blocks.device:
            raise ValueError(f"lru_hits: {name} on {t.device}, blocks on {blocks.device}")
        if not t.is_contiguous():
            raise ValueError(f"lru_hits: {name} must be contiguous")
    if blocks.dim() != 1 or offsets.shape != (rows + 1,) or age.shape != tags.shape:
        raise ValueError(
            f"lru_hits: shapes blocks {tuple(blocks.shape)}, offsets "
            f"{tuple(offsets.shape)}, tags {tuple(tags.shape)}, age {tuple(age.shape)}"
        )
    if not 1 <= ways <= MAX_WAYS:
        raise ValueError(f"lru_hits: ways must be in [1, {MAX_WAYS}], got {ways}")


def lru_hits(blocks, offsets, tags, age):
    """LRU hit bits of a ragged set-sorted stream, resuming from a carry.

    ``blocks`` (N,) int32 holds row ``r``'s accesses, in stream order, at
    ``[offsets[r], offsets[r + 1])``; ``tags`` / ``age`` (rows, ways) int32
    are each row's carried state.  Returns ``(hits, tags_out, age_out)``:
    ``hits`` (N,) uint8 0/1 per access, and each row's final raw state
    (ages are positions within the row plus 1; canonicalize on the host).
    """
    _check(blocks, offsets, tags, age)
    if blocks.device.type == "cpu":
        return lru_hits_plain(blocks, offsets, tags, age)
    rows, ways = tags.shape
    if blocks.data_ptr() % 16:  # the kernel copies 16-byte chunks
        blocks = blocks.clone()
    hits = torch.empty(blocks.shape[0], dtype=torch.uint8, device=blocks.device)
    tags_out = torch.empty_like(tags)
    age_out = torch.empty_like(age)
    lib = load(SOURCE)
    fn = lib.lru_hits_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    rc = fn(
        ptr(blocks), ptr(offsets), rows, ways, ptr(tags), ptr(age),
        ptr(tags_out), ptr(age_out), ptr(hits), stream_ptr(blocks.device),
    )
    if rc:
        raise RuntimeError(f"lru_hits launch failed with CUDA error {rc}")
    lru_hits.launches += 1
    return hits, tags_out, age_out


lru_hits.launches = 0


def ragged_to_padded(blocks, offsets, pad: int = -1):
    """``(max_len, rows)`` matrix of the ragged rows (column prefixes,
    ``pad`` tails) plus each access's ``(col, row)`` cell."""
    rows = offsets.shape[0] - 1
    counts = offsets[1:] - offsets[:-1]
    max_len = int(counts.max()) if rows else 0
    row = torch.repeat_interleave(
        torch.arange(rows, device=blocks.device), counts, output_size=blocks.shape[0]
    )
    col = torch.arange(blocks.shape[0], device=blocks.device) - offsets[:-1][row]
    padded = torch.full((max_len, rows), pad, dtype=blocks.dtype, device=blocks.device)
    padded[col, row] = blocks
    return padded, col, row


def lru_hits_plain(blocks, offsets, tags, age):
    """Plain PyTorch version of :func:`lru_hits`: every row advances one
    access per step over the padded matrix, with the fused victim select
    ``argmin(where(hit, INT32_MIN, age))``; pads are masked out of the
    update.  Same outputs as the kernel, bit for bit."""
    padded, col, row = ragged_to_padded(blocks, offsets)
    tags, age = tags.clone(), age.clone()
    lanes = torch.arange(tags.shape[1], device=tags.device)
    hit_mat = torch.zeros(padded.shape, dtype=torch.bool, device=tags.device)
    for t in range(padded.shape[0]):
        b = padded[t][:, None]
        hitv = tags == b
        hit_mat[t] = hitv.any(dim=1)
        way = torch.where(hitv, _INT32_MIN, age).argmin(dim=1)
        onehot = (way[:, None] == lanes) & (b >= 0)
        tags = torch.where(onehot, b, tags)
        age = torch.where(onehot, t + 1, age)
    return hit_mat[col, row].to(torch.uint8), tags, age


__all__ = ["MAX_WAYS", "SOURCE", "lru_hits", "lru_hits_plain", "ragged_to_padded"]
