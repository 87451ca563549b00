"""Public API: AMC recorded-stream property gather for the graph apps.

``AMCGatherSession`` carries the two recorded index streams and swaps roles
at every iteration boundary, mirroring ``AMC.update()``: the stream
recorded during iteration k drives the gather of iteration k+1 (kernel
K4a on the card).  A mismatch mask (current frontier vs recorded stream)
falls back to a plain gather for the changed rows —
prefetch-for-the-stable-part, demand-for-the-changed-part, exactly the
paper's coverage behavior.

Ported from ``repro.kernels.amc_gather.ops`` with ``device=`` in place of
``interpret=``.  The cold branch and the fix-up of changed rows use
:func:`gather_ref`, the reference's own demand path outside the kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.amc_gather.amc_gather import amc_gather, amc_gather_segment_sum
from repro_torch.kernels.amc_gather.ref import gather_ref

__all__ = ["AMCGatherSession", "amc_gather", "amc_gather_segment_sum", "gather_ref"]


class AMCGatherSession:
    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.recorded: Optional[np.ndarray] = None
        self.recording: Optional[np.ndarray] = None
        self.stats = {"replayed": 0, "fallback": 0}

    def update(self):
        """Iteration boundary: role swap (AMC.update())."""
        self.recorded = self.recording
        self.recording = None

    def _indices(self, idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32)).to(self.device)

    def gather(self, table: torch.Tensor, indices) -> torch.Tensor:
        """Gather rows of ``table`` (on the session's device); replay the
        recorded stream where it still matches.  ``indices`` is a numpy
        array or a tensor of row ids in ``[0, len(table))``."""
        if table.device != self.device:
            raise ValueError(f"AMCGatherSession: table on {table.device}, session on {self.device}")
        idx_np = (
            indices.cpu().numpy() if isinstance(indices, torch.Tensor) else np.asarray(indices)
        )
        if len(idx_np) and (idx_np.min() < 0 or idx_np.max() >= table.shape[0]):
            raise IndexError(f"AMCGatherSession: indices outside [0, {table.shape[0]})")
        self.recording = idx_np  # record this iteration's stream
        rec = self.recorded
        if rec is not None and len(rec) == len(idx_np) and np.array_equal(rec, idx_np):
            self.stats["replayed"] += 1
            return amc_gather(table, self._indices(rec))
        if rec is not None and len(rec) == len(idx_np):
            # Partial match: replay recorded stream, fix changed rows.
            self.stats["replayed"] += 1
            out = amc_gather(table, self._indices(rec))
            changed = rec != idx_np
            if changed.any():
                self.stats["fallback"] += 1
                rows = torch.from_numpy(np.flatnonzero(changed)).to(self.device)
                out[rows] = gather_ref(table, self._indices(idx_np[changed]))
            return out
        self.stats["fallback"] += 1
        return gather_ref(table, self._indices(idx_np))
