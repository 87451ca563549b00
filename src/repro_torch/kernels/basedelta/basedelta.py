"""K3a / K3b: BaseΔ compression of AMC entry tiles (CUDA kernels + plain
PyTorch versions).

Replaces the Pallas kernels ``repro/kernels/basedelta/basedelta.py``
``basedelta_compress_tiles`` and ``basedelta_decompress_tiles``.  On a CUDA
tensor each wrapper launches its kernel in ``csrc/basedelta.cu`` (per-row
step and K3b's thread-to-element map in ``csrc/basedelta_step.h``; K3b
takes 16-byte units or single elements, see :func:`decompress_route`); on
a CPU tensor it runs the plain version,
:func:`~repro_torch.kernels.basedelta.ref.compress_ref` /
:func:`~repro_torch.kernels.basedelta.ref.decompress_ref`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.basedelta.ref import compress_ref, decompress_ref
from repro_torch.kernels.build import load, ptr, stream_ptr

SOURCE = Path(__file__).resolve().parent / "csrc" / "basedelta.cu"

basedelta_compress_plain = compress_ref
basedelta_decompress_plain = decompress_ref


def _check(name, tiles, row_vec):
    e = tiles.shape[0] if tiles.dim() == 2 else -1
    if tiles.dim() != 2 or tiles.shape[1] < 1 or row_vec.shape != (e,):
        raise ValueError(
            f"{name}: expects (E, W>=1) tiles and (E,) rows; got "
            f"{tuple(tiles.shape)} and {tuple(row_vec.shape)}"
        )
    for t in (tiles, row_vec):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: inputs must be int32, got {t.dtype}")
        if t.device != tiles.device:
            raise ValueError(f"{name}: inputs on {t.device} and {tiles.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


@functools.cache
def _fn(name: str, n_ptr_before: int, n_int_after: int, n_ptr_after: int):
    """The C entry point ``name``, bound once per process."""
    fn = getattr(load(SOURCE), name)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptr_before + [ctypes.c_int64, ctypes.c_int]
        + [ctypes.c_int] * n_int_after + [ctypes.c_void_p] * n_ptr_after
    )
    fn.restype = ctypes.c_int
    return fn


def decompress_route(deltas: torch.Tensor, out: torch.Tensor) -> str:
    """K3b's route: ``"vector"`` (16-byte units) when the width is a
    multiple of 4 and both views are 16-byte aligned, else ``"scalar"``."""
    aligned = deltas.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return "vector" if deltas.shape[1] % 4 == 0 and aligned else "scalar"


def basedelta_compress_tiles(blocks: torch.Tensor, counts: torch.Tensor):
    """``(deltas (E, W) int32, mode (E,) int32)``: per entry row, the deltas
    against column 0 on the row's ``counts`` valid columns (0 on the rest)
    and the mode 0/1/2 of the largest |delta| (≤127, ≤32767, wider)."""
    _check("basedelta_compress_tiles", blocks, counts)
    if blocks.device.type == "cpu":
        return basedelta_compress_plain(blocks, counts)
    e, w = blocks.shape
    deltas = torch.empty_like(blocks)
    mode = torch.empty(e, dtype=torch.int32, device=blocks.device)
    if e == 0:
        return deltas, mode
    rc = _fn("basedelta_compress_launch", 2, 0, 3)(
        ptr(blocks), ptr(counts), e, w, ptr(deltas), ptr(mode),
        stream_ptr(blocks.device),
    )
    if rc:
        raise RuntimeError(f"basedelta_compress_tiles launch failed with CUDA error {rc}")
    basedelta_compress_tiles.launches += 1
    return deltas, mode


def basedelta_decompress_tiles(base: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """``base[:, None] + deltas`` (E, W) int32, wrapping as int32."""
    _check("basedelta_decompress_tiles", deltas, base)
    if deltas.device.type == "cpu":
        return basedelta_decompress_plain(base, deltas)
    e, w = deltas.shape
    out = torch.empty_like(deltas)
    if e == 0:
        return out
    fn = _fn("basedelta_decompress_launch", 2, 1, 2)
    route = decompress_route(deltas, out)
    rc = fn(ptr(base), ptr(deltas), e, w, int(route == "vector"), ptr(out),
            stream_ptr(deltas.device))
    if rc:
        raise RuntimeError(f"basedelta_decompress_tiles launch failed with CUDA error {rc}")
    basedelta_decompress_tiles.launches += 1
    basedelta_decompress_tiles.routes[route] += 1
    return out


basedelta_compress_tiles.launches = 0
basedelta_decompress_tiles.launches = 0
basedelta_decompress_tiles.routes = {"vector": 0, "scalar": 0}  # launches by route

__all__ = [
    "SOURCE",
    "basedelta_compress_plain",
    "basedelta_compress_tiles",
    "basedelta_decompress_plain",
    "basedelta_decompress_tiles",
    "decompress_route",
]
