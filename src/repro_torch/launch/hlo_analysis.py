"""Collective byte counting for the roofline (the port of
``repro/launch/hlo_analysis.py``).

The port lowers nothing to HLO: a step runs eagerly, and its collectives
are the ones DTensor issues when it lays tensors out, which
``torch.distributed.tensor.debug.CommDebugMode`` sees.
:class:`CommBytesMode` is that mode, also keeping each collective's result
bytes, and :func:`comm_bytes` turns its trace into the JAX record:
``{kind: {"count", "bytes"}, "total_bytes"}``, bytes being the result
shape's bytes on the rank (for an all-gather the gathered size; for a
reduce-scatter the scattered size; the roofline applies the link factors).
:func:`collective_bytes` keeps the JAX package's parser of HLO text, for
records that come from it.
"""
from __future__ import annotations

import re
from typing import Dict

import torch
from torch.distributed.tensor.debug import CommDebugMode

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1,
    "pred": 1, "c64": 8, "c128": 16,
}

COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(segment: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(segment):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def _record() -> Dict[str, dict]:
    return {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}


def _total(out: Dict[str, dict]) -> Dict[str, dict]:
    out["total_bytes"] = sum(v["bytes"] for v in out.values() if isinstance(v, dict))
    return out


def collective_bytes(hlo_text: str) -> Dict[str, dict]:
    """Per-collective-kind {count, bytes} from HLO text (the op's
    result-shape bytes)."""
    out = _record()
    for line in hlo_text.splitlines():
        for kind in COLLECTIVES:
            token = f" {kind}("
            idx = line.find(token)
            if idx < 0:
                # fused/start variants: all-reduce-start(
                token = f" {kind}-start("
                idx = line.find(token)
                if idx < 0:
                    continue
            lhs = line[:idx]
            if "=" not in lhs:
                continue
            result_seg = lhs.split("=", 1)[1]
            out[kind]["count"] += 1
            out[kind]["bytes"] += _shape_bytes(result_seg)
            break
    return _total(out)


def _kind(op_name: str) -> str:
    """The JAX kind of a PyTorch collective's name (functional or c10d)."""
    if "reduce_scatter" in op_name:
        return "reduce-scatter"
    if "all_gather" in op_name or "allgather" in op_name:
        return "all-gather"
    if "all_reduce" in op_name or "allreduce" in op_name:
        return "all-reduce"
    if "all_to_all" in op_name or "alltoall" in op_name:
        return "all-to-all"
    raise ValueError(f"no JAX collective kind for {op_name}")


def _tensor_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_tensor_bytes(o) for o in out)
    return 0


class CommBytesMode(CommDebugMode):
    """``CommDebugMode`` that also keeps ``(op name, result bytes on the
    rank)`` of every collective in ``calls``."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = sum(self.comm_counts.values())
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and sum(self.comm_counts.values()) > before:
            # for the c10d in-place ops the result is the output argument
            res = args[0] if "c10d." in str(func) and not str(func).startswith("_c10d_") else out
            self.calls.append((str(func), _tensor_bytes(res)))
        return out


def comm_bytes(mode: CommBytesMode) -> Dict[str, dict]:
    """The JAX record ``{kind: {count, bytes}, total_bytes}`` of the
    collectives that ``mode`` saw: ``all_reduce`` is ``all-reduce``,
    ``all_gather_into_tensor`` ``all-gather``, ``reduce_scatter_tensor``
    ``reduce-scatter``, ``all_to_all_single`` ``all-to-all``."""
    out = _record()
    for name, nbytes in mode.calls:
        kind = _kind(name)
        out[kind]["count"] += 1
        out[kind]["bytes"] += nbytes
    return _total(out)


__all__ = ["COLLECTIVES", "CommBytesMode", "DTYPE_BYTES", "collective_bytes", "comm_bytes"]
