"""K4a / K4b: AMC recorded-stream gather (CUDA kernels + plain PyTorch
versions).

Replaces the Pallas kernels ``repro/kernels/amc_gather/amc_gather.py``
``amc_gather`` (``table[indices]``, the recorded stream driving the row DMA
one step ahead) and ``amc_gather_segment_sum`` (the push-mode EDGEMAP
consumer: per-segment float32 sums of the gathered rows).  On a CUDA tensor
each wrapper launches its kernel in ``csrc/amc_gather.cu``; on a CPU tensor
it runs the plain version, :func:`~repro_torch.kernels.amc_gather.ref.
gather_ref` / :func:`~repro_torch.kernels.amc_gather.ref.
gather_segment_sum_ref`.

Indices must lie in ``[0, V)`` and ``segments`` must be non-decreasing
and lie in ``[0, num_segments)``, as for the Pallas kernels; the wrappers
check types and shapes only, since a check of the values would wait on the
device.  The kernels stay inside the arrays on any input: an index outside
the table gives a zero row (K4a) or adds nothing (K4b).  Unlike the Pallas
kernel, which leaves them unwritten, K4b writes 0 into empty segments, as
the plain version does.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.amc_gather.ref import gather_ref, gather_segment_sum_ref
from repro_torch.kernels.build import load, ptr, stream_ptr

SOURCE = Path(__file__).resolve().parent / "csrc" / "amc_gather.cu"
DTYPES = (torch.float32, torch.bfloat16)

amc_gather_plain = gather_ref
amc_gather_segment_sum_plain = gather_segment_sum_ref


def _check(name, table, *index_arrays):
    if table.dim() != 2:
        raise ValueError(f"{name}: table must be (V, D), got {tuple(table.shape)}")
    if table.dtype not in DTYPES:
        raise TypeError(f"{name}: table must be float32 or bfloat16, got {table.dtype}")
    n = index_arrays[0].shape
    for t in index_arrays:
        if t.dim() != 1 or t.shape != n:
            raise ValueError(f"{name}: index arrays must be one (N,) shape")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index arrays must be int32, got {t.dtype}")
    for t in (table, *index_arrays):
        if t.device != table.device:
            raise ValueError(f"{name}: inputs on {t.device} and {table.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def amc_gather(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``table[indices]`` (N, D) from a (V, D) float32 / bfloat16 table and
    an (N,) int32 recorded index stream."""
    _check("amc_gather", table, indices)
    if table.device.type == "cpu":
        return amc_gather_plain(table, indices)
    (v, d), n = table.shape, indices.shape[0]
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n == 0 or d == 0:
        return out
    fn = load(SOURCE).amc_gather_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ptr(table), v, d, table.element_size(), ptr(indices), n, ptr(out),
            stream_ptr(table.device))
    if rc:
        raise RuntimeError(f"amc_gather launch failed with CUDA error {rc}")
    amc_gather.launches += 1
    return out


def amc_gather_segment_sum(
    table: torch.Tensor,
    indices: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
) -> torch.Tensor:
    """``out[s] = Σ table[indices[i]]`` over ``segments[i] == s`` (S, D),
    accumulated in float32 in index order and cast to the table's dtype;
    empty segments are 0."""
    _check("amc_gather_segment_sum", table, indices, segments)
    if num_segments < 0:
        raise ValueError(f"amc_gather_segment_sum: num_segments {num_segments} < 0")
    if table.device.type == "cpu":
        return amc_gather_segment_sum_plain(table, indices, segments, num_segments)
    (v, d), n = table.shape, indices.shape[0]
    out = torch.empty((num_segments, d), dtype=table.dtype, device=table.device)
    if num_segments == 0 or d == 0:
        return out
    fn = load(SOURCE).amc_gather_segment_sum_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ptr(table), v, d, int(table.dtype == torch.bfloat16), ptr(indices),
            ptr(segments), n, num_segments, ptr(out), stream_ptr(table.device))
    if rc:
        raise RuntimeError(f"amc_gather_segment_sum launch failed with CUDA error {rc}")
    amc_gather_segment_sum.launches += 1
    return out


amc_gather.launches = 0
amc_gather_segment_sum.launches = 0

__all__ = [
    "DTYPES",
    "SOURCE",
    "amc_gather",
    "amc_gather_plain",
    "amc_gather_segment_sum",
    "amc_gather_segment_sum_plain",
]
