"""The reference of the ``moe`` family (Mixtral): each layer pre-norm
attention with rope, then a routed SwiGLU mixture of experts.

Routing as the JAX package defines it (``repro/models/moe.py``, read, not
imported): router logits in float32; the top ``k`` experts of each token
by logit, the lower expert first on equal logits; their weights the
softmax of those ``k`` logits; a capacity of ``max(int(c N k / E), 1)``
slots an expert for the call's ``N`` tokens (``c`` the configuration's
``moe_capacity_factor``); the ``N k`` slots, token by token and expert
choice by choice, ranked within their expert in that order, and a slot
whose rank reaches the capacity dropped.  A token's
output is the weighted sum of its kept slots' experts.

Leaves (``tree_shapes``): the embedding, the final norm and an untied head;
each layer's two norms, attention and experts with their router, stacked
over ``blocks``.

Parts: ``k.<layer>`` and ``v.<layer>`` (B, S, KV, hd), keys after rope;
``branches``, ``(owner (n,), logits (n, V))``: the last position's logits
under each routing of it that a near tie admits (see :func:`branch_moe`),
``owner`` the request of each."""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from perfbench.reference.common import (
    Matmul,
    attention_block,
    embed,
    last_attention_block,
    last_logits,
    rms_norm,
    swiglu,
)
from perfbench.weights import attention_shapes, padded_vocab

# The program routes from bf16 activations, the reference from float32 ones,
# so where the reference's routing of a request's last position lies near a
# tie, the program's may fall the other way: another expert (a k-th and a
# (k+1)-th router logit closer than ROUTE_MARGIN), or the other side of an
# expert's capacity (a slot's rank within RANK_MARGIN of the capacity, which
# flips of the tokens before it move).  The reference follows the last
# position through every such routing, and the check judges the program by
# the closest one; the other positions' flips move the last position only
# through attention, within rounding.
ROUTE_MARGIN = 0.05  # router logits
RANK_MARGIN = 0.025  # of the capacity
MAX_BRANCHES = 1024  # routings followed a request; past it the request is unjudged


def tree_shapes(cfg: dict) -> dict:
    """Path -> shape of every leaf the forward reads."""
    d, L, f = cfg["d_model"], cfg["num_layers"], cfg["d_ff"]
    vp = padded_vocab(cfg["vocab_size"])
    out = {("embed",): (vp, d), ("final_norm",): (d,), ("lm_head",): (vp, d)}
    e = cfg["moe_experts"]
    out[("blocks", "ln1")] = (L, d)
    out[("blocks", "ln2")] = (L, d)
    for k, s in attention_shapes(cfg).items():
        out[("blocks", "attn", k)] = (L, *s)
    for k, s in {"router": (d, e), "wg": (e, d, f), "wu": (e, d, f),
                 "wd": (e, f, d)}.items():
        out[("blocks", "moe", k)] = (L, *s)
    return out


def moe(p: dict, i: int, x, cfg: dict, mm: Matmul, rows: int = 1):
    """Layer ``i``'s mixture of experts on the rows of ``x`` (N, D), which
    hold ``rows`` requests one after another: ``(y, before, capacity)``,
    where ``before`` (rows, E) counts, for each request's last token, the
    slots of the tokens before it in each expert."""
    n = x.shape[0]
    e, k = cfg["moe_experts"], cfg["moe_top_k"]
    capacity = max(int(cfg["moe_capacity_factor"] * n * k / e), 1)
    logits = mm(x, p["router"][i])
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights = torch.softmax(top[:, :k], dim=-1).reshape(-1)
    slot_e = idx[:, :k].reshape(-1)
    token = torch.arange(n, device=x.device).repeat_interleave(k)
    y = torch.zeros_like(x)
    for j in range(e):
        slots = (slot_e == j).nonzero()[:, 0]  # in slot order: rank 0, 1, ...
        mine = slots[:capacity]  # the rest dropped
        t = token[mine]
        out = swiglu(x[t], p["wg"][i, j], p["wu"][i, j], p["wd"][i, j], mm)
        y.index_add_(0, t, out * weights[mine, None])
    counts = F.one_hot(slot_e, e).cumsum(0)  # (N k, E): slots up to and with each
    last = torch.arange(1, rows + 1, device=x.device) * (n // rows) - 1
    before = torch.where((last > 0)[:, None], counts[(last * k - 1).clamp(min=0)], 0)
    return y, before, capacity


def branch_moe(p: dict, i: int, xl, owner, before, capacity: int, cfg: dict, mm: Matmul,
               eps: float):
    """Layer ``i``'s mixture of experts on last-position states ``xl`` (n, D)
    of the requests ``owner``, each state followed through every routing
    the margins admit: every set of k experts whose least router logit lies
    above the largest outside it less ``ROUTE_MARGIN``, and for each of its
    slots both kept and dropped where its rank (``before``) lies within
    ``RANK_MARGIN`` of the capacity.  Returns the states after the layer's
    residual and their owners."""
    e, k = cfg["moe_experts"], cfg["moe_top_k"]
    h = rms_norm(xl, p["ln2"][i], eps)
    logits = mm(h, p["moe"]["router"][i])
    combos = torch.combinations(torch.arange(e, device=xl.device), k)
    if combos.dim() == 1:
        combos = combos[:, None]
    inside = F.one_hot(combos, e).sum(1).bool()  # (C, E)
    least = logits[:, combos].min(-1).values  # (n, C)
    most_out = logits[:, None, :].masked_fill(inside[None], float("-inf")).max(-1).values
    ok = least > most_out - ROUTE_MARGIN
    out = {}
    for j in range(e):
        rows = (ok & inside[:, j]).any(1).nonzero()[:, 0]
        if rows.numel():
            m = p["moe"]
            y = swiglu(h[rows], m["wg"][i, j], m["wu"][i, j], m["wd"][i, j], mm)
            out.update({(int(r), j): y[t] for t, r in enumerate(rows)})
    new_x, new_owner = [], []
    for b in range(xl.shape[0]):
        r = int(owner[b])
        for c in ok[b].nonzero()[:, 0].tolist():
            experts = combos[c].tolist()
            w = torch.softmax(logits[b, combos[c]], dim=-1)
            options = []
            for j in experts:
                rank = int(before[r, j])
                near = abs(rank - capacity) < RANK_MARGIN * capacity
                options.append((True, False) if near else (rank < capacity,))
            for kept in itertools.product(*options):
                y = torch.zeros_like(xl[b])
                for m, j in enumerate(experts):
                    if kept[m]:
                        y = y + w[m] * out[(b, j)]
                new_x.append(xl[b] + y)
                new_owner.append(r)
    return torch.stack(new_x), torch.tensor(new_owner, device=xl.device)


def run(cfg: dict, tree: dict, tokens, mm: Matmul):
    eps = cfg["rms_norm_eps"]
    blocks = tree["blocks"]
    x = embed(tree, tokens)
    b, s, d = x.shape
    xl, owner = x[:, -1].clone(), torch.arange(b, device=x.device)
    for i in range(cfg["num_layers"]):
        layer = {"ln1": blocks["ln1"][i],
                 "attn": {w: blocks["attn"][w][i] for w in ("wq", "wk", "wv", "wo")}}
        x, k, v = attention_block(layer, x, cfg, mm, eps)
        xl = last_attention_block(layer, xl, owner, k, v, cfg, mm, eps)
        yield f"k.{i}", k
        yield f"v.{i}", v
        h = rms_norm(x, blocks["ln2"][i], eps).view(b * s, d)
        y, before, capacity = moe(blocks["moe"], i, h, cfg, mm, rows=b)
        x = x + y.view(b, s, d)
        xl, owner = branch_moe(blocks, i, xl, owner, before, capacity, cfg, mm, eps)
        many = torch.bincount(owner, minlength=b) > MAX_BRANCHES
        if many.any():  # past the cap: the request is left unjudged
            xl, owner = xl[~many[owner]], owner[~many[owner]]
        del k, v
    yield "branches", (owner, last_logits(tree, xl[:, None], cfg, mm, eps))
    yield "logits", last_logits(tree, x, cfg, mm, eps)


def program_parts(cfg: dict, cache) -> dict:
    """``prefill_step``'s ``(k, v)`` stacked over layers (L, B, S, KV, hd)
    by part name."""
    k, v = cache
    out = {}
    for i in range(k.shape[0]):
        out[f"k.{i}"], out[f"v.{i}"] = k[i], v[i]
    return out
