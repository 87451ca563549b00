"""Compress / round-trip AMC entry tables through the BaseΔ tile kernels.

Block-line ids in this system fit int32 (46-bit physical addresses in the
paper map to <2^26 line ids at our scale); the 46-bit base is carried
exactly on the host side, the kernel handles the delta lanes.

Ported from ``repro.kernels.basedelta.ops`` with ``device=`` in place of
``interpret=``: the tile kernels run on the device the caller names
(default the CUDA card; ``"cpu"`` runs their plain versions).  Packing
ragged entries into tiles and reassembling them are vectorized numpy here
(the JAX package loops over entries in Python); the arrays are identical.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.basedelta.basedelta import (
    basedelta_compress_tiles,
    basedelta_decompress_tiles,
)

MODE_BYTES = np.array([1, 2, 4, 8])


def pack_ragged(miss_blocks: np.ndarray, offsets: np.ndarray, width: int = 32):
    """Ragged entries -> fixed (E, width) int32 tiles + int32 counts.

    Entries must fit the tile width — the AMC binder splits at 20 misses
    (paper Fig 16), so width 32 always holds."""
    offsets = np.asarray(offsets, dtype=np.int64)
    e = len(offsets) - 1
    counts = np.diff(offsets).astype(np.int32)
    if counts.max(initial=0) > width:
        raise ValueError(
            f"entry of {counts.max()} misses exceeds tile width {width}; "
            "split entries first (AMC caps at 20)"
        )
    tiles = np.zeros((e, width), np.int32)
    if e:
        tiles[np.arange(width)[None, :] < counts[:, None]] = np.asarray(
            miss_blocks[offsets[0] : offsets[-1]]
        ).astype(np.int32)
    return tiles, counts


def _to(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def compress_entries(
    miss_blocks: np.ndarray, offsets: np.ndarray, width: int = 32, device: DeviceLike = None
):
    """Returns (bases, deltas, modes, counts, compressed_bytes)."""
    dev = resolve_device(device)
    tiles, counts = pack_ragged(miss_blocks, offsets, width)
    deltas, modes = basedelta_compress_tiles(_to(tiles, dev), _to(counts, dev))
    modes_np = modes.cpu().numpy()
    nbytes = 7 + np.maximum(counts - 1, 0) * MODE_BYTES[modes_np]
    return tiles[:, 0], deltas.cpu().numpy(), modes_np, counts, int(nbytes.sum())


def roundtrip(
    miss_blocks: np.ndarray, offsets: np.ndarray, width: int = 32, device: DeviceLike = None
):
    """Compress + decompress; returns the reconstructed ragged stream."""
    dev = resolve_device(device)
    base, deltas, _, counts, _ = compress_entries(miss_blocks, offsets, width, dev)
    rec = basedelta_decompress_tiles(_to(base, dev), _to(deltas, dev)).cpu().numpy()
    return rec[np.arange(width)[None, :] < counts[:, None]].astype(np.int64)


__all__ = [
    "MODE_BYTES",
    "basedelta_compress_tiles",
    "basedelta_decompress_tiles",
    "compress_entries",
    "pack_ragged",
    "roundtrip",
]
