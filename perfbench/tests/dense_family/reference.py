"""The reference of a family the benchmark has no module for, added as
files alone by the discovery test (copied to ``reference/dense.py``): the
port's ``dense`` family with a tied head, as it runs smollm-360m.  Each
layer pre-norm attention with rope, then SwiGLU; the head is the embedding.

Leaves (``tree_shapes``): the embedding and the final norm, no head; each
layer's two norms, attention and MLP, stacked over ``blocks``.  Parts:
``k.<layer>`` and ``v.<layer>`` (B, S, KV, hd), keys after rope."""
from __future__ import annotations

import torch

from perfbench.reference.common import (
    Matmul,
    attention_block,
    embed,
    last_logits,
    rms_norm,
    swiglu,
)
from perfbench.weights import attention_shapes, padded_vocab


def tree_shapes(cfg: dict) -> dict:
    d, L, f = cfg["d_model"], cfg["num_layers"], cfg["d_ff"]
    out = {("embed",): (padded_vocab(cfg["vocab_size"]), d), ("final_norm",): (d,),
           ("blocks", "ln1"): (L, d), ("blocks", "ln2"): (L, d)}
    for k, s in attention_shapes(cfg).items():
        out[("blocks", "attn", k)] = (L, *s)
    for k, s in {"wg": (d, f), "wu": (d, f), "wd": (f, d)}.items():
        out[("blocks", "mlp", k)] = (L, *s)
    return out


def draw_leaf(path, shape, generator, dtype, device, layers):
    """The tied table at ``N(0, 1 / d)``, a head's scale, since it is the
    head too; every other leaf by the harness's rules."""
    if path == ("embed",):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype).mul_(shape[-1] ** -0.5)
    return None


def run(cfg: dict, tree: dict, tokens, mm: Matmul):
    eps = cfg["rms_norm_eps"]
    blocks = tree["blocks"]
    x = embed(tree, tokens)
    for i in range(cfg["num_layers"]):
        layer = {"ln1": blocks["ln1"][i],
                 "attn": {w: blocks["attn"][w][i] for w in ("wq", "wk", "wv", "wo")}}
        x, k, v = attention_block(layer, x, cfg, mm, eps)
        yield f"k.{i}", k
        yield f"v.{i}", v
        m = blocks["mlp"]
        x = x + swiglu(rms_norm(x, blocks["ln2"][i], eps), m["wg"][i], m["wu"][i], m["wd"][i],
                       mm)
    yield "logits", last_logits(tree, x, cfg, mm, eps)


def program_parts(cfg: dict, cache) -> dict:
    """``prefill_step``'s ``(k, v)`` stacked over layers (L, B, S, KV, hd)."""
    k, v = cache
    out = {}
    for i in range(k.shape[0]):
        out[f"k.{i}"], out[f"v.{i}"] = k[i], v[i]
    return out
