"""K6: the Mamba2 SSD chunk scan (CUDA kernel + plain PyTorch version).

Replaces the Pallas kernel ``repro/kernels/ssd_scan/ssd_scan.py``
``ssd_scan`` and, on the model path, ``repro/models/ssm.py::ssd_chunked``,
in the model's layout: x ``(B, S, H, P)`` and B, C ``(B, S, N)`` in one
dtype (float32 or bfloat16), dt ``(B, S, H)`` and a ``(H,)`` float32, an
optional float32 ``init_state`` ``(B, H, P, N)``.  Returns y in x's dtype
and the float32 final state, which the Pallas kernel does not produce.  On
a CUDA tensor the wrapper launches the kernels in ``csrc/ssd_scan.cu``
(``P`` in {32, 64}, ``N`` in {16, 64, 128}, a chunk of at most 64 or a
multiple of 64 up to 1024): three passes on the tensor cores, chunk by
chunk in parallel, with a float32 scratch of one state per (batch, chunk,
head) between them.  On a CPU tensor it runs the plain version
:func:`~repro_torch.kernels.ssd_scan.ref.ssd_chunked_plain`.  Both mask
the intra-chunk decay before the exponent (see ``ref.py``).  The kernels
have no backward: on a CUDA input that requires grad under grad mode the
wrapper raises, where its outputs would silently cut the graph.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import load, ptr, stream_ptr
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64)
STATE_DIMS = (16, 64, 128)
MAX_CHUNK = 1024


def _check(x, dt, a, b, c, chunk, init_state):
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    if dt.shape != (bsz, s, h) or a.shape != (h,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} / a {tuple(a.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if b.dim() != 3 or b.shape[:2] != (bsz, s) or c.shape != b.shape:
        raise ValueError(f"ssd_scan: b and c must be one (B, S, N) shape, got "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, b, c must share float32 or bfloat16, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and a must be float32, got {dt.dtype}, {a.dtype}")
    if chunk <= 0:
        raise ValueError(f"ssd_scan: chunk {chunk} <= 0")
    if init_state is not None:
        if init_state.shape != (bsz, h, p, b.shape[2]) or init_state.dtype != torch.float32:
            raise ValueError(f"ssd_scan: init_state must be float32 {(bsz, h, p, b.shape[2])}")
    for t in (dt, a, b, c) + (() if init_state is None else (init_state,)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: inputs on {t.device} and {x.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data is not 16-byte aligned (the
    kernel loads 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_view(t: torch.Tensor, dense: int) -> torch.Tensor:
    """``t`` as the kernel reads it: its last ``dense`` dimensions packed
    (x: heads x P, B and C: N), its batch and position strides any
    multiple of 16 bytes, its data 16-byte aligned; otherwise a contiguous
    copy.  The model's x, B and C are slices of one projection, which the
    kernel reads in place."""
    inner = 1
    packed = True
    for d in range(t.dim() - 1, t.dim() - 1 - dense, -1):
        packed = packed and (t.shape[d] == 1 or t.stride(d) == inner)
        inner *= t.shape[d]
    unit = 16 // t.element_size()
    if (packed and t.data_ptr() % 16 == 0
            and all(t.shape[d] == 1 or t.stride(d) % unit == 0 for d in range(t.dim() - dense))):
        return t
    return _aligned(t.contiguous())


def _outer_strides(t: torch.Tensor):
    """Batch and position strides of ``t`` (0 where the size is 1)."""
    return tuple(t.stride(d) if t.shape[d] > 1 else 0 for d in (0, 1))


@functools.cache
def _entry():
    """The library's launch function and its count of bf16 planes of a
    chunk's starting state, by route."""
    lib = load(SOURCE)
    fn = lib.ssd_scan_launch
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [vp] * 12 + [i64] * 8 + [ci, ci, ci, ci, ci, vp]
    fn.restype = ci
    lib.ssd_scan_state_parts.argtypes = [ci]
    lib.ssd_scan_state_parts.restype = ci
    return fn, {b: lib.ssd_scan_state_parts(b) for b in (0, 1)}


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    chunk: int = 256,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan; returns ``(y (B, S, H, P), final_state (B, H, P, N))``."""
    _check(x, dt, a, b, c, chunk, init_state)
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, a, b, c, chunk, init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, a, b, c, init_state)):
        # the kernels write fresh tensors that autograd cannot follow
        raise RuntimeError("ssd_scan has no backward: an input requires grad; "
                           "differentiate kernels.ssd_scan.ref.ssd_chunked_plain")
    bsz, s, h, p = x.shape
    n = b.shape[2]
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd_scan: (P, N) = ({p}, {n}) not supported on CUDA "
                         f"(P in {HEAD_DIMS}, N in {STATE_DIMS})")
    if chunk > MAX_CHUNK or (chunk > 64 and chunk % 64):
        raise ValueError(f"ssd_scan: chunk {chunk} not supported on CUDA "
                         f"(at most 64, or a multiple of 64 up to {MAX_CHUNK})")
    x, b, c = _kernel_view(x, 2), _kernel_view(b, 1), _kernel_view(c, 1)
    dt, a = dt.contiguous(), a.contiguous()
    if init_state is not None:
        init_state = init_state.contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if bsz == 0 or h == 0:
        return y, final
    nc = -(-s // chunk)
    lpad = -(-chunk // 16) * 16 if chunk <= 64 else chunk
    is_bf16 = int(x.dtype == torch.bfloat16)
    fn, parts = _entry()
    # pass A writes each chunk's own state (as S^T), cum[L-1] and its
    # per-position running sums; pass B each chunk's starting state as bf16
    # planes; pass C reads the planes and the running sums
    states = torch.empty((bsz, nc, h, n, p), dtype=torch.float32, device=x.device)
    last = torch.empty((bsz, nc, h), dtype=torch.float32, device=x.device)
    planes = torch.empty((bsz, nc, h, parts[is_bf16], n, p), dtype=torch.bfloat16,
                         device=x.device)
    pos = torch.empty((bsz, nc, h, lpad, 4), dtype=torch.float32, device=x.device)
    rc = fn(ptr(x), ptr(dt), ptr(a), ptr(b), ptr(c),
            None if init_state is None else ptr(init_state), ptr(y), ptr(final),
            ptr(states), ptr(last), ptr(planes), ptr(pos),
            *_outer_strides(x), *_outer_strides(b), *_outer_strides(c), bsz, s, h, p, n, chunk,
            is_bf16, stream_ptr(x.device))
    if rc:
        raise RuntimeError(f"ssd_scan launch failed with CUDA error {rc}")
    ssd_scan.launches += 1
    ssd_scan.routes[str(x.dtype).split(".")[1]] += 1
    return y, final


ssd_scan.launches = 0
# launches by route: bfloat16 inputs (exact in bf16; G, w B and S in two
# bf16 parts) and float32 inputs (everything in SSD_F32_PARTS parts)
ssd_scan.routes = {"bfloat16": 0, "float32": 0}

__all__ = ["DTYPES", "HEAD_DIMS", "MAX_CHUNK", "SOURCE", "STATE_DIMS", "ssd_scan"]
