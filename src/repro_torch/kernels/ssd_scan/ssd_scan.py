"""K6: the Mamba2 SSD chunk scan (CUDA kernel + plain PyTorch version).

Replaces the Pallas kernel ``repro/kernels/ssd_scan/ssd_scan.py``
``ssd_scan`` and, on the model path, ``repro/models/ssm.py::ssd_chunked``,
in the model's layout: x ``(B, S, H, P)`` and B, C ``(B, S, N)`` in one
dtype (float32 or bfloat16), dt ``(B, S, H)`` and a ``(H,)`` float32, an
optional float32 ``init_state`` ``(B, H, P, N)``.  Returns y in x's dtype
and the float32 final state, which the Pallas kernel does not produce.  On
a CUDA tensor the wrapper launches the kernel in ``csrc/ssd_scan.cu``
(``P`` in {32, 64}, ``N`` in {16, 64, 128}, a chunk of at most 64 or a
multiple of 64 up to 1024); on a CPU tensor it runs the plain version
:func:`~repro_torch.kernels.ssd_scan.ref.ssd_chunked_plain`.  Both mask
the intra-chunk decay before the exponent (see ``ref.py``).
"""
from __future__ import annotations

import ctypes
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
    bsz, s, h, p = x.shape
    n = b.shape[2]
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd_scan: (P, N) = ({p}, {n}) not supported on CUDA "
                         f"(P in {HEAD_DIMS}, N in {STATE_DIMS})")
    if chunk > MAX_CHUNK or (chunk > 64 and chunk % 64):
        raise ValueError(f"ssd_scan: chunk {chunk} not supported on CUDA "
                         f"(at most 64, or a multiple of 64 up to {MAX_CHUNK})")
    x, dt, a, b, c = (t.contiguous() for t in (x, dt, a, b, c))
    if init_state is not None:
        init_state = init_state.contiguous()
    y = torch.empty_like(x)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if bsz == 0 or h == 0:
        return y, final
    fn = load(SOURCE).ssd_scan_launch
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [vp] * 8 + [i64, i64, ci, ci, ci, ci, ci, vp]
    fn.restype = ci
    rc = fn(ptr(x), ptr(dt), ptr(a), ptr(b), ptr(c),
            None if init_state is None else ptr(init_state), ptr(y), ptr(final),
            bsz, s, h, p, n, chunk, int(x.dtype == torch.bfloat16), stream_ptr(x.device))
    if rc:
        raise RuntimeError(f"ssd_scan launch failed with CUDA error {rc}")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0

__all__ = ["DTYPES", "HEAD_DIMS", "MAX_CHUNK", "SOURCE", "STATE_DIMS", "ssd_scan"]
