"""BaseΔ compression of AMC miss streams (paper §V-B, Figs 5/6).

An AMC entry holds up to 20 miss block addresses (46-bit physical block
addresses in the paper). The first miss is the base; the rest are encoded as
1-, 2- or 4-byte signed deltas — the smallest size that fits every delta in
the entry is chosen (all three tested in parallel in hardware). Entries
whose deltas exceed 4 bytes are stored raw.

Encoded entry layout (bits):  8 (mode+count)  +  46 (base)  +  (n-1)*8*δ
Raw entry layout:             8               +  n*46

This module is the *bit-accounting and reference* implementation (numpy,
exact round-trip); :mod:`repro_torch.kernels.basedelta` is the CUDA version
operating on fixed-width tiles.
"""
from __future__ import annotations

import dataclasses

import numpy as np

BASE_BITS = 46
HEADER_BITS = 8
MODE_BYTES = {0: 1, 1: 2, 2: 4, 3: None}  # 3 = raw


def select_modes(miss_blocks: np.ndarray, seg_ids: np.ndarray, n_entries: int):
    """Vectorized per-entry mode selection.

    ``miss_blocks``: int64 block addresses, grouped by contiguous ``seg_ids``
    (ascending). Returns (mode, nmiss, bits) arrays of length ``n_entries``.
    """
    if n_entries == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.int8), z, z
    nmiss = np.bincount(seg_ids, minlength=n_entries).astype(np.int64)
    starts = np.zeros(n_entries, dtype=np.int64)
    np.cumsum(nmiss[:-1], out=starts[1:])
    # Delta of each miss vs its entry's base (the first miss of the entry).
    base = miss_blocks[np.minimum(starts, max(len(miss_blocks) - 1, 0))]
    deltas = miss_blocks - base[seg_ids]
    absmax = np.zeros(n_entries, dtype=np.int64)
    np.maximum.at(absmax, seg_ids, np.abs(deltas))
    mode = np.full(n_entries, 3, dtype=np.int8)
    mode[absmax <= 2**31 - 1] = 2
    mode[absmax <= 2**15 - 1] = 1
    mode[absmax <= 2**7 - 1] = 0
    delta_bytes = np.array([1, 2, 4, 0])[mode]
    bits = np.where(
        mode < 3,
        HEADER_BITS + BASE_BITS + np.maximum(nmiss - 1, 0) * 8 * delta_bytes,
        HEADER_BITS + nmiss * BASE_BITS,
    )
    bits = np.where(nmiss == 0, 0, bits)
    return mode, nmiss, bits


def basedelta_compress(blocks: np.ndarray) -> tuple:
    """Compress ONE entry. Returns (mode, packed_bytes) — exact round-trip."""
    blocks = np.asarray(blocks, dtype=np.int64)
    n = len(blocks)
    assert n >= 1
    base = blocks[0]
    deltas = blocks - base
    absmax = int(np.abs(deltas).max())
    if absmax <= 2**7 - 1:
        mode, width = 0, 1
    elif absmax <= 2**15 - 1:
        mode, width = 1, 2
    elif absmax <= 2**31 - 1:
        mode, width = 2, 4
    else:
        mode, width = 3, None
    header = np.array([mode << 5 | n], dtype=np.uint8).tobytes()
    if mode == 3:
        return mode, header + blocks.astype("<i8").tobytes()
    body = base.astype("<i8").tobytes()[:6]  # 46-bit base, 6-byte container
    dt = {1: "<i1", 2: "<i2", 4: "<i4"}[width]
    body += deltas[1:].astype(dt).tobytes()
    return mode, header + body


def basedelta_decompress(packed: bytes) -> np.ndarray:
    """Inverse of :func:`basedelta_compress`."""
    header = packed[0]
    mode, n = header >> 5, header & 0x1F
    if mode == 3:
        return np.frombuffer(packed[1:], dtype="<i8")[:n].copy()
    base = int.from_bytes(packed[1:7], "little", signed=False)
    if base >= 1 << 45:  # sign-extend 46-bit
        base -= 1 << 46
    width = MODE_BYTES[mode]
    dt = {1: "<i1", 2: "<i2", 4: "<i4"}[width]
    deltas = np.frombuffer(packed[7 : 7 + (n - 1) * width], dtype=dt)
    out = np.empty(n, dtype=np.int64)
    out[0] = base
    out[1:] = base + deltas.astype(np.int64)
    return out


def compressed_entry_bytes(mode: int, nmiss: int) -> int:
    """Byte size of the reference pack (raw mode uses 8-byte containers;
    the hardware bit-accounting in select_modes uses 46-bit addresses)."""
    if mode == 3:
        return 1 + nmiss * 8
    return (HEADER_BITS + BASE_BITS + max(nmiss - 1, 0) * 8 * MODE_BYTES[mode] + 7) // 8


@dataclasses.dataclass
class CompressionStats:
    """Aggregate ratios, mirroring the paper's §V-B measurements."""

    uncompressed_bits: int = 0
    compressed_bits: int = 0
    entries: int = 0
    mode_counts: tuple = (0, 0, 0, 0)

    def add(self, mode: np.ndarray, nmiss: np.ndarray, bits: np.ndarray):
        self.uncompressed_bits += int((nmiss * BASE_BITS).sum())
        self.compressed_bits += int(bits.sum())
        self.entries += int((nmiss > 0).sum())
        mc = list(self.mode_counts)
        for m in range(4):
            mc[m] += int((mode[nmiss > 0] == m).sum())
        self.mode_counts = tuple(mc)

    @property
    def ratio(self) -> float:
        return self.uncompressed_bits / max(self.compressed_bits, 1)
