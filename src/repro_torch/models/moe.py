"""Mixture-of-Experts layer: top-k routing and capacity-based dispatch (the
port of ``repro/models/moe.py``).

Dispatch is the gather/scatter form (sort by expert, drop what overflows
an expert's capacity), not the masked-dense form: the expert products run
over ``(E, C, D)`` slots, as in the JAX package.  The JAX package computes
routing, dispatch, the expert products and the combine in jnp, outside any
Pallas kernel; so does the port, in PyTorch: the dispatch is an
``index_put`` with accumulation, the three expert products are batched
matmuls (``torch.bmm``), the combine an ``index_add`` over the slots'
tokens.  The JAX package's ``shard_hint``s (the capacity axis over the
batch axes above 16,384 tokens) place tensors on a device mesh and mean
nothing on one card; they are left out.

``recorded_plan`` replays a dispatch plan recorded on an earlier step (the
AMC-technique integration): slots whose replayed expert is stale get zero
weight from the current router, so the output stays exact for the slots
the plan keeps.

Determinism: the dispatch adds only zeros onto a kept slot, and with
``top_k <= 2`` the combine adds at most two terms onto zero, which give
the same float in either order; so on the card, where ``index_put`` and
``index_add`` accumulate in no fixed order, the output does not depend on
it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class MoEParams(NamedTuple):
    router: torch.Tensor  # (D, E)
    w_gate: torch.Tensor  # (E, D, F)
    w_up: torch.Tensor  # (E, D, F)
    w_down: torch.Tensor  # (E, F, D)


def route_topk(x: torch.Tensor, router: torch.Tensor, top_k: int) -> tuple:
    """Returns ``(expert_idx (N, k), weights (N, k), aux_loss)``.  The top
    k come from a stable descending sort, so on equal logits the lower
    expert comes first, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order on ties)."""
    logits = x.float() @ router.float()
    srt, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights, idx = srt[:, :top_k], order[:, :top_k]
    weights = torch.softmax(weights, dim=-1)
    # Load-balancing aux loss (Switch-style): E * sum_e f_e * p_e
    probs = torch.softmax(logits, dim=-1)
    e = router.shape[1]
    density = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    p_mean = probs.mean(dim=0)
    aux = e * torch.sum(density * p_mean)
    return idx, weights.to(x.dtype), aux


def _dispatch_plan(expert_idx: torch.Tensor, num_experts: int, capacity: int):
    """Sort token-slots by expert; assign within-expert ranks; drop overflow.

    Returns ``(slot_expert, slot_rank, keep)`` over the flattened ``(N*k,)``
    slots."""
    flat_e = expert_idx.reshape(-1)
    nk = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idxs = torch.arange(nk, device=flat_e.device)
    # rank within expert = position - first position of that expert
    seg_start = torch.ones(nk, dtype=torch.bool, device=flat_e.device)
    seg_start[1:] = sorted_e[1:] != sorted_e[:-1]
    start_idx = torch.cummax(torch.where(seg_start, idxs, 0), dim=0).values
    rank = torch.empty(nk, dtype=torch.int32, device=flat_e.device)
    rank[order] = (idxs - start_idx).to(torch.int32)
    keep = rank < capacity
    return flat_e, rank, keep


def moe_ffn(
    x: torch.Tensor,  # (N, D) flattened tokens
    p: MoEParams,
    top_k: int,
    capacity_factor: float = 1.25,
    recorded_plan: Optional[tuple] = None,
) -> tuple:
    """Returns ``(y (N, D), aux_loss, plan)``; ``plan`` can be replayed as
    ``recorded_plan`` next step (AMC recorded dispatch)."""
    n, d = x.shape
    e = p.router.shape[1]
    capacity = max(int(capacity_factor * n * top_k / e), 1)

    expert_idx, weights, aux = route_topk(x, p.router, top_k)
    if recorded_plan is not None:
        # replay: dispatch along the recorded plan; stale slots are
        # zero-weighted by the current router output below
        flat_e, rank, keep = (t.to(x.device) for t in recorded_plan)
        flat_e, rank, keep = flat_e.long(), rank.to(torch.int32), keep.bool()
    else:
        flat_e, rank, keep = _dispatch_plan(expert_idx, e, capacity)
    plan = (flat_e, rank, keep)

    token_of_slot = torch.arange(n, device=x.device).repeat_interleave(top_k)
    # weight slots by the current router only where the replayed expert
    # matches the current assignment
    cur_e = expert_idx.reshape(-1)
    w_slot = torch.where(flat_e == cur_e, weights.reshape(-1), 0.0)
    w_slot = torch.where(keep, w_slot, 0.0)

    safe_rank = torch.where(keep, rank, capacity - 1).long()
    dispatch = torch.zeros((e, capacity, d), dtype=x.dtype, device=x.device).index_put(
        (flat_e, safe_rank), torch.where(keep[:, None], x[token_of_slot], 0.0), accumulate=True)
    g = torch.bmm(dispatch, p.w_gate.to(x.dtype))
    u = torch.bmm(dispatch, p.w_up.to(x.dtype))
    y_exp = torch.bmm(F.silu(g) * u, p.w_down.to(x.dtype))

    y_slot = y_exp[flat_e, safe_rank] * w_slot[:, None].to(x.dtype)
    y = torch.zeros((n, d), dtype=x.dtype, device=x.device).index_add(0, token_of_slot, y_slot)
    return y, aux, plan


__all__ = ["MoEParams", "moe_ffn", "route_topk"]
