"""Mixture-of-Experts layer: top-k routing and capacity-based dispatch (the
port of ``repro/models/moe.py``).

Dispatch is the gather/scatter form (sort by expert, drop what overflows
an expert's capacity), not the masked-dense form: the expert products run
over ``(E, C, D)`` slots, as in the JAX package.  The JAX package computes
routing, dispatch, the expert products and the combine in jnp, outside any
Pallas kernel; so does the port, in PyTorch: the dispatch is an
``index_put`` with accumulation, the three expert products are batched
matmuls (``torch.bmm``), the combine an ``index_add`` over the slots'
tokens.  Above 16,384 tokens the capacity axis is laid out over the
batch axes, as the JAX package's ``shard_hint``s do (a no-op off a device
mesh): without it the dispatch scatter replicates the ``(E, C, D)``
tensor on every device; at decode-sized batches the capacity dim is tiny
and the reshard would be pure overhead.

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

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.sharding import reduce_partial, shard_hint, to_layout


class MoEParams(NamedTuple):
    router: torch.Tensor  # (D, E)
    w_gate: torch.Tensor  # (E, D, F)
    w_up: torch.Tensor  # (E, D, F)
    w_down: torch.Tensor  # (E, F, D)


def route_topk(x: torch.Tensor, router: torch.Tensor, top_k: int,
               mean_rows: Optional[Callable] = None) -> tuple:
    """Returns ``(expert_idx (N, k), weights (N, k), aux_loss)``.  The top
    k come from a stable descending sort, so on equal logits the lower
    expert comes first, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order on ties).  ``mean_rows`` averages an ``(N, E)``
    tensor over the tokens for the aux loss (default: over ``x``'s rows; on
    a mesh, over every rank's)."""
    logits = x.float() @ router.float()
    srt, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights, idx = srt[:, :top_k], order[:, :top_k]
    weights = torch.softmax(weights, dim=-1)
    # Load-balancing aux loss (Switch-style): E * sum_e f_e * p_e
    mean = mean_rows or (lambda t: t.mean(dim=0))
    e = router.shape[1]
    density = mean(F.one_hot(idx[:, 0], e).float())
    p_mean = mean(torch.softmax(logits, dim=-1))
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


def _same(t, *spec):
    return t


def _dispatch(x_slot, flat_e, safe_rank, keep, e: int, capacity: int):
    """The ``(E, C, D)`` expert inputs: each kept slot's row at its expert
    and rank, zeros elsewhere."""
    return torch.zeros((e, capacity, x_slot.shape[-1]), dtype=x_slot.dtype,
                       device=x_slot.device).index_put(
        (flat_e, safe_rank), torch.where(keep[:, None], x_slot, 0.0), accumulate=True)


def _experts(dispatch, p: MoEParams, hint):
    """The SwiGLU experts as three batched products over the slots."""
    dt = dispatch.dtype
    g = torch.bmm(dispatch, p.w_gate.to(dt))
    u = torch.bmm(dispatch, p.w_up.to(dt))
    h = hint(F.silu(g) * u, None, "batch", "model")
    return hint(torch.bmm(h, p.w_down.to(dt)), None, "batch", None)


def _combine(y_exp, flat_e, safe_rank, w_slot, token, rows: int):
    """``(rows, D)``: each slot's expert output times its weight, added
    onto its token's row."""
    y_slot = y_exp[flat_e, safe_rank] * w_slot[:, None].to(y_exp.dtype)
    return torch.zeros((rows, y_exp.shape[-1]), dtype=y_exp.dtype,
                       device=y_exp.device).index_add(0, token, y_slot)


def moe_ffn(
    x: torch.Tensor,  # (N, D) flattened tokens
    p: MoEParams,
    top_k: int,
    capacity_factor: float = 1.25,
    recorded_plan: Optional[tuple] = None,
) -> tuple:
    """Returns ``(y (N, D), aux_loss, plan)``; ``plan`` can be replayed as
    ``recorded_plan`` next step (AMC recorded dispatch).  A DTensor ``x``
    (tokens on a device mesh) takes :func:`_moe_ffn_mesh`."""
    if isinstance(x, DTensor):
        if recorded_plan is not None:
            raise ValueError("a recorded plan is replayed on one device, not on a mesh")
        return _moe_ffn_mesh(x, p, top_k, capacity_factor)
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

    hint = shard_hint if n >= 16384 else _same
    safe_rank = torch.where(keep, rank, capacity - 1).long()
    dispatch = hint(_dispatch(x[token_of_slot], flat_e, safe_rank, keep, e, capacity),
                    None, "batch", None)
    y_exp = _experts(dispatch, p, hint)
    y = _combine(y_exp, flat_e, safe_rank, w_slot, token_of_slot, n)
    return hint(y, "batch", None), aux, plan


def _moe_ffn_mesh(x, p: MoEParams, top_k: int, capacity_factor: float) -> tuple:
    """``moe_ffn`` of tokens split by rows over the mesh's batch axes (a
    DTensor): the same routing, plan, dispatch, experts and combine, with
    the collectives made explicit where DTensor has no rule (a global sort,
    a scatter and a gather indexed by the plan):

    - routing on each rank's rows against the router gathered whole; the
      aux loss's means from the ranks' sums (all-reduces of E numbers);
    - the plan (``_dispatch_plan``) on every rank from the expert ids of all
      tokens (an all-gather of ``N k`` ids: the routing metadata);
    - dispatch: each rank scatters its kept slots into a whole ``(E, C, D)``
      buffer, summed over the batch axes, reduce-scattered along C above
      16,384 tokens (the JAX hint's layout, C over the batch axes) and
      all-reduced below it (replicated);
    - the expert products by DTensor against the weights' own plan;
    - combine: below 16,384 tokens each rank takes its own slots' rows;
      above it each rank adds the slots its part of C holds into a whole
      ``(N, D)`` buffer, reduce-scattered back to the rows.

    Each slot and token row receives its terms from one rank and zeros from
    the rest, so the sums are the single-device ones (for ``top_k <= 2``).
    The buffers are ``E C D`` and ``N k D`` elements a rank."""
    mesh = x.device_mesh
    bdims = [i for i, q in enumerate(x.placements) if q.is_shard(0)]

    def over_batch(batch, other=Replicate()):
        return [batch if i in bdims else other for i in range(mesh.ndim)]

    rows, rep, part = over_batch(Shard(0)), over_batch(Replicate()), over_batch(Partial())
    xl = to_layout(reduce_partial(x), mesh, rows).to_local()
    n, d = x.shape
    nb, r = 1, 0  # row chunks, and this rank's (major mesh dim first)
    for i in bdims:
        nb, r = nb * mesh.size(i), r * mesh.size(i) + mesh.get_local_rank(i)
    if n % nb:
        raise ValueError(f"{n} tokens do not split evenly over {nb}")
    nl = n // nb
    e = p.router.shape[1]
    capacity = max(int(capacity_factor * n * top_k / e), 1)
    big = n >= 16384
    if big and capacity % nb:
        raise ValueError(f"capacity {capacity} does not split evenly over {nb}")

    # The collectives are DTensor layout changes, differentiable; a tensor
    # each rank holds whole but uses for its own rows or slots takes its
    # gradient as partial over the batch axes.
    def layout(t, src, dst, grad=None):
        return DTensor.from_local(t, mesh, src, run_check=False).redistribute(
            mesh, dst).to_local(grad_placements=grad)

    def all_sum(t):
        return layout(t, part, rep)

    def gather_rows(t):
        return layout(t, rows, rep, grad=part)

    def scatter_sum(t, dim):
        return layout(t, part, over_batch(Shard(dim)))

    router = to_layout(p.router, mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=part)
    idx, weights, aux = route_topk(xl, router, top_k,
                                   mean_rows=lambda t: all_sum(t.sum(dim=0)) / n)
    aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim, run_check=False)

    flat_e, rank, keep = _dispatch_plan(gather_rows(idx), e, capacity)
    safe_rank = torch.where(keep, rank, capacity - 1).long()
    token = torch.arange(n, device=xl.device).repeat_interleave(top_k)
    mine = slice(r * nl * top_k, (r + 1) * nl * top_k)
    fe, sr, kp = flat_e[mine], safe_rank[mine], keep[mine]
    disp = _dispatch(xl[token[mine] - r * nl], fe, sr, kp, e, capacity)
    disp = scatter_sum(disp, 1) if big else all_sum(disp)
    cap_layout = over_batch(Shard(1)) if big else rep
    hint = shard_hint if big else _same
    y_exp = _experts(DTensor.from_local(disp, mesh, cap_layout, run_check=False), p, hint)
    y_exp = to_layout(reduce_partial(y_exp), mesh, cap_layout).to_local(
        grad_placements=None if big else part)
    if big:  # the slots this rank's part of C holds, onto every token's row
        cl = capacity // nb
        held = keep & (safe_rank >= r * cl) & (safe_rank < (r + 1) * cl)
        w_all = torch.where(held, gather_rows(weights).reshape(-1), 0.0)
        y = scatter_sum(_combine(y_exp, flat_e, torch.clamp(safe_rank - r * cl, 0, cl - 1),
                                 w_all, token, n), 0)
    else:  # this rank's own slots, onto its rows
        w_mine = torch.where(kp, weights.reshape(-1), 0.0)
        y = _combine(y_exp, fe, sr, w_mine, token[mine] - r * nl, nl)
    y = DTensor.from_local(y, mesh, rows, run_check=False)
    return hint(y, "batch", None), aux, (flat_e, rank, keep)


__all__ = ["MoEParams", "moe_ffn", "route_topk"]
