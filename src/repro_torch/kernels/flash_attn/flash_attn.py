"""K5: blocked causal / sliding-window attention (CUDA kernel + plain
PyTorch version).

Replaces the Pallas kernel ``repro/kernels/flash_attn/flash_attn.py``
``flash_attention`` and, on the model path, the jnp scan
``repro/models/attention.py::blocked_attention``, in the model's layout:
q ``(B, Sq, H, hd)``, k and v ``(B, Skv, KV, hd)``, float32 or bfloat16,
``hd`` in {32, 64, 128}.  On a CUDA tensor the wrapper launches the kernel
in ``csrc/flash_attn.cu``; on a CPU tensor it runs the plain version
:func:`~repro_torch.kernels.flash_attn.ref.blocked_attention_plain`.
The kernel has no backward: on a CUDA input that requires grad under grad
mode the wrapper raises, where its output would silently cut the graph.
The kernel's route follows the dtype and nothing else; both run on the
tensor cores (``mma.sync``): bfloat16 with P split into two bfloat16
parts, float32 with every operand (scaled Q, K, P, V) split into three
bfloat16 parts and each product taken as six ``mma`` of pairs of parts,
which holds float32's tolerance (one TF32 or bfloat16 product could
not).

The kernel follows blocked_attention's query scaling (``q * scale`` in the
input dtype, then float32); the Pallas kernel scales after the cast.  The
two agree exactly for hd = 64 (a power-of-two scale) and differ by one
rounding of q for bfloat16 at hd = 32 and 128.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load, ptr, stream_ptr
from repro_torch.kernels.flash_attn.ref import blocked_attention_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attn.cu"
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (B, Sq, H, hd) and k, v (B, Skv, KV, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} heads are not a multiple of {k.shape[2]} kv heads")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("flash_attention: q, k and v on different devices")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sliding_window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Softmax attention of q over k, v with an online softmax; returns
    ``(B, Sq, H, hd)`` in q's dtype."""
    _check(q, k, v)
    if sliding_window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: sliding_window {sliding_window} and q_offset "
                         f"{q_offset} must be >= 0")
    if q.device.type == "cpu":
        return blocked_attention_plain(q, k, v, causal, sliding_window, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the kernel writes a fresh tensor that autograd cannot follow
        raise RuntimeError("flash_attention has no backward: an input requires grad; "
                           "differentiate kernels.flash_attn.ref.blocked_attention_plain")
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS} on CUDA")
    if b * h > 65535:
        raise ValueError(f"flash_attention: batch x heads {b * h} > 65535 on CUDA")
    q, k, v = (t.contiguous() for t in (q, k, v))
    # both routes copy 16-byte segments with cp.async
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    scale = float(torch.tensor(hd**-0.5, dtype=q.dtype))
    fn = load(SOURCE).flash_attn_launch
    i64, ci = ctypes.c_int64, ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [i64, i64, i64, ci, ci, ci, ci,
                                           ctypes.c_float, ci, i64, i64, ctypes.c_void_p]
    fn.restype = ci
    rc = fn(ptr(q), ptr(k), ptr(v), ptr(out), b, sq, skv, h, kvh, hd,
            int(q.dtype == torch.bfloat16), scale, int(causal), int(sliding_window),
            int(q_offset), stream_ptr(q.device))
    if rc:
        raise RuntimeError(f"flash_attention launch failed with CUDA error {rc}")
    flash_attention.launches += 1
    flash_attention.routes[str(q.dtype).split(".")[1]] += 1
    return out


flash_attention.launches = 0
flash_attention.routes = {"bfloat16": 0, "float32": 0}  # launches by route

__all__ = ["DTYPES", "HEAD_DIMS", "SOURCE", "flash_attention"]
