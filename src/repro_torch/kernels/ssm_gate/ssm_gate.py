"""The Mamba2 block's gate: the D skip, the ``silu(z)`` gate and the gated
RMSNorm over ``d_inner`` (CUDA kernel + plain PyTorch version).

Replaces no Pallas kernel: the JAX package writes this chain in jnp after
the scan (``repro/models/ssm.py::ssm_block``), which XLA fuses.  In the
model's layout: the scan's ``y`` and the input projection's ``xh``, both
``(B, S, H, P)``, and ``z`` ``(B, S, d_inner)``, in one dtype (float32 or
bfloat16); the D skip ``d_skip`` ``(H,)`` and the norm's weight ``norm``
``(d_inner,)``, in one dtype (float32 or bfloat16).  It returns
``(B, S, d_inner)`` in ``y``'s dtype::

    v   = (y + xh * d_skip) * silu(z)
    out = rnd(v * rsqrt(mean(v^2 over d_inner) + 1e-6) * norm)

in float32 up to the one rounding ``rnd``.  On a CUDA tensor the wrapper
launches ``csrc/ssm_gate.cu``, one pass that reads ``y``, ``xh`` and ``z``
once (``xh`` and ``z`` in place, as the strided views of the projection
they are) and writes the output once, where the plain version
(:func:`ssm_gate_plain`) runs eleven float32 ops, each writing a tensor of
every position's ``d_inner`` channels; on a CPU tensor it runs the plain
version.  The kernel's arithmetic is the plain version's, in its order,
except the order of the mean's sum (``csrc/ssm_gate_step.h``).  It has no
backward: on a CUDA input that requires grad under grad mode the wrapper
raises.  :func:`gated_rms_norm` is the chain after the D skip, which the
decode step shares.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import load, ptr, stream_ptr

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_gate.cu"
DTYPES = (torch.float32, torch.bfloat16)
EPS = 1e-6
MAX_UNITS = 256 * 4  # 16-byte units a row: SSM_GATE_THREADS * SSM_GATE_MAX_K


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """float32 ``y`` (..., d_inner) gated by ``silu(z)``, RMS-normed over
    its last dimension and scaled by ``norm``, in float32."""
    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + EPS)) * norm


def ssm_gate_plain(y, xh, z, d_skip, norm) -> torch.Tensor:
    """The gate in plain PyTorch: ``(B, S, d_inner)`` in ``xh``'s dtype."""
    y = y + xh.float() * d_skip[None, None, :, None]
    return gated_rms_norm(y.reshape(z.shape), z, norm).to(xh.dtype)


def _unit(t: torch.Tensor) -> int:
    """Elements of ``t``'s dtype in a 16-byte unit."""
    return 16 // t.element_size()


def _check(y, xh, z, d_skip, norm):
    if y.dim() != 4 or xh.shape != y.shape:
        raise ValueError(f"ssm_gate: y and xh must be one (B, S, H, P) shape, got "
                         f"{tuple(y.shape)}, {tuple(xh.shape)}")
    bsz, s, h, p = y.shape
    if z.shape != (bsz, s, h * p) or d_skip.shape != (h,) or norm.shape != (h * p,):
        raise ValueError(f"ssm_gate: z {tuple(z.shape)}, d_skip {tuple(d_skip.shape)}, norm "
                         f"{tuple(norm.shape)} do not fit y {tuple(y.shape)}")
    if y.dtype not in DTYPES or xh.dtype != y.dtype or z.dtype != y.dtype:
        raise TypeError(f"ssm_gate: y, xh, z must share float32 or bfloat16, got "
                        f"{y.dtype}, {xh.dtype}, {z.dtype}")
    if d_skip.dtype not in DTYPES or norm.dtype != d_skip.dtype:
        raise TypeError(f"ssm_gate: d_skip and norm must share float32 or bfloat16, got "
                        f"{d_skip.dtype}, {norm.dtype}")
    for t in (xh, z, d_skip, norm):
        if t.device != y.device:
            raise ValueError(f"ssm_gate: inputs on {t.device} and {y.device}")
    unit = _unit(y)
    if p % unit or (h * p) // unit > MAX_UNITS:
        raise ValueError(f"ssm_gate: P {p} must be a multiple of {unit} and d_inner {h * p} at "
                         f"most {MAX_UNITS * unit} in {y.dtype}")
    if bsz > 65535:
        raise ValueError(f"ssm_gate: batch {bsz} > 65,535")
    # each position's d_inner channels dense; batch and position strides in
    # whole 16-byte units (a size-1 dimension's stride is never used)
    for name, t, inner in (("y", y, 2), ("xh", xh, 2), ("z", z, 1)):
        dense = t.stride(-1) == 1 and (inner == 1 or t.stride(2) == p or h == 1)
        if not dense or any(t.shape[i] > 1 and t.stride(i) % unit for i in (0, 1)):
            raise ValueError(f"ssm_gate: {name} strides {t.stride()} are not dense channels at "
                             f"batch and position strides of whole {unit}-element units")
        if t.data_ptr() % 16:
            raise ValueError(f"ssm_gate: {name}'s data is not 16-byte aligned")


def _outer_strides(t: torch.Tensor):
    """Batch and position strides of ``t`` (0 where the size is 1)."""
    return tuple(t.stride(i) if t.shape[i] > 1 else 0 for i in (0, 1))


@functools.cache
def _entry():
    fn = load(SOURCE).ssm_gate_launch
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [vp] * 6 + [i64] * 8 + [ci] * 4 + [vp]
    fn.restype = ci
    return fn


def ssm_gate(y, xh, z, d_skip, norm) -> torch.Tensor:
    """The gate of ``y``, ``xh`` (B, S, H, P) and ``z`` (B, S, d_inner):
    ``(B, S, d_inner)`` in ``y``'s dtype."""
    _check(y, xh, z, d_skip, norm)
    if y.device.type == "cpu":
        return ssm_gate_plain(y, xh, z, d_skip, norm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, xh, z, d_skip, norm)):
        # the kernel writes a fresh tensor that autograd cannot follow
        raise RuntimeError("ssm_gate has no backward: an input requires grad; "
                           "differentiate kernels.ssm_gate.ssm_gate.ssm_gate_plain")
    bsz, s, h, p = y.shape
    out = torch.empty(z.shape, dtype=y.dtype, device=y.device)
    if out.numel() == 0:
        return out
    d_skip, norm = d_skip.contiguous(), norm.contiguous()
    rc = _entry()(ptr(y), ptr(xh), ptr(z), ptr(d_skip), ptr(norm), ptr(out),
                  *_outer_strides(y), *_outer_strides(xh), *_outer_strides(z), bsz, s, h * p, p,
                  int(y.dtype == torch.bfloat16), int(norm.dtype == torch.bfloat16),
                  stream_ptr(y.device))
    if rc:
        raise RuntimeError(f"ssm_gate launch failed with CUDA error {rc}")
    ssm_gate.launches += 1
    return out


ssm_gate.launches = 0

__all__ = ["DTYPES", "EPS", "SOURCE", "gated_rms_norm", "ssm_gate", "ssm_gate_plain"]
