"""Plain PyTorch oracles for the AMC gather kernels (K4a, K4b); also the
kernels' plain versions (:mod:`.amc_gather`)."""
from __future__ import annotations

import torch


def gather_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``table[indices]``: rows of the (V, D) table, one per index."""
    return table[indices.long()]


def gather_segment_sum_ref(
    table: torch.Tensor,
    indices: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
) -> torch.Tensor:
    """``out[s] = Σ table[indices[i]]`` over ``segments[i] == s``, summed in
    float32 and cast to the table's dtype; empty segments are 0.  On the
    CPU ``index_add_`` adds in index order, as ``jax.ops.segment_sum``
    does on XLA-CPU."""
    rows = table[indices.long()].to(torch.float32)
    out = torch.zeros(
        (num_segments, table.shape[1]), dtype=torch.float32, device=table.device
    )
    out.index_add_(0, segments.long(), rows)
    return out.to(table.dtype)


__all__ = ["gather_ref", "gather_segment_sum_ref"]
