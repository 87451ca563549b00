"""Ordered float32 segment sum (CUDA kernel + plain PyTorch version).

``out[d] = sum of values[e] over edges e with segment_ids[e] == d``, added
sequentially in edge order from 0.0 — the float sequence of
``jax.ops.segment_sum`` on XLA-CPU and of ``index_add_`` on the CPU, which
the plain version uses.  On a CUDA tensor :func:`segment_sum` launches
``csrc/segment_sum.cu``, which walks each segment's edges through a stable
destination sort (``perm``, ``offsets``) built once per edge array by
:func:`segment_plan`: a warp for each segment of more than ``CHUNK`` edges
(the plan's ``heavy`` list, longest first), a thread for each other one.
``index_add_`` on CUDA adds with atomics in an order that changes from run
to run, so it cannot stand in.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.build import load, ptr, stream_ptr

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_sum.cu"
CHUNK = 32  # SS_CHUNK of csrc/segment_sum_step.h: longer segments take a warp


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Destination grouping of one edge array, on one device."""

    ids: torch.Tensor  # (E,) int64 segment id per edge
    perm: torch.Tensor  # (E,) int32 edge ids, stably sorted by segment
    offsets: torch.Tensor  # (num_segments + 1,) int64 segment starts in perm
    heavy: torch.Tensor  # (H,) int32 segments of more than CHUNK edges, longest first
    num_segments: int


def segment_plan(segment_ids, num_segments: int, device) -> SegmentPlan:
    """Build the plan of ``segment_ids`` (host numpy sort, done once)."""
    ids = np.asarray(segment_ids, dtype=np.int64)
    if len(ids) >= 2**31:
        raise ValueError("segment_plan: edge ids must fit in int32")
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    counts = np.bincount(ids, minlength=num_segments)
    offsets = np.zeros(num_segments + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    heavy = np.flatnonzero(counts > CHUNK)
    heavy = heavy[np.argsort(-counts[heavy], kind="stable")].astype(np.int32)
    return SegmentPlan(
        ids=torch.from_numpy(ids).to(device),
        perm=torch.from_numpy(perm).to(device),
        offsets=torch.from_numpy(offsets).to(device),
        heavy=torch.from_numpy(heavy).to(device),
        num_segments=num_segments,
    )


def segment_sum(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Per-segment float32 sums of ``values`` (E,), in edge order."""
    if values.dtype != torch.float32 or values.shape != plan.ids.shape:
        raise ValueError(
            f"segment_sum: values must be float32 of shape {tuple(plan.ids.shape)}"
        )
    if values.device != plan.ids.device:
        raise ValueError(f"segment_sum: values on {values.device}, plan on {plan.ids.device}")
    if values.device.type == "cpu":
        return segment_sum_plain(values, plan.ids, plan.num_segments)
    values = values.contiguous()
    out = torch.empty(plan.num_segments, dtype=torch.float32, device=values.device)
    lib = load(SOURCE)
    fn = lib.segment_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    rc = fn(
        ptr(values), ptr(plan.perm), ptr(plan.offsets), plan.num_segments,
        ptr(plan.heavy), plan.heavy.numel(), ptr(out), stream_ptr(values.device),
    )
    if rc:
        raise RuntimeError(f"segment_sum launch failed with CUDA error {rc}")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def segment_sum_plain(values, segment_ids, num_segments: int) -> torch.Tensor:
    """Plain version: ``index_add_``, which adds in edge order on the CPU."""
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, segment_ids, values)


__all__ = ["CHUNK", "SOURCE", "SegmentPlan", "segment_plan", "segment_sum", "segment_sum_plain"]
