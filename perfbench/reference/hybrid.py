"""The reference of the ``hybrid`` family (Zamba2): groups of
``hybrid_attn_every`` Mamba2 layers, each group followed by the one shared
attention block (pre-norm attention with rope, then SwiGLU), then the tail
Mamba2 layers, the final norm and the head.

Leaves (``tree_shapes``): the embedding, the final norm and an untied head;
the layers' entry norms and Mamba2 blocks stacked over ``blocks``; the one
shared block's norms, attention and MLP under ``shared_attn``.

Parts: ``state.<layer>`` (B, H, P, N), each Mamba2 layer's final SSM state;
``k.<group>`` and ``v.<group>`` (B, S, KV, hd), the shared block's keys
(after rope) and values at each call."""
from __future__ import annotations

from perfbench.reference.common import (
    Matmul,
    attention_block,
    embed,
    last_logits,
    mamba2,
    rms_norm,
    swiglu,
)
from perfbench.weights import attention_shapes, padded_vocab


def tree_shapes(cfg: dict) -> dict:
    """Path -> shape of every leaf the forward reads."""
    d, L, f = cfg["d_model"], cfg["num_layers"], cfg["d_ff"]
    vp = padded_vocab(cfg["vocab_size"])
    out = {("embed",): (vp, d), ("final_norm",): (d,), ("lm_head",): (vp, d)}
    d_in = cfg["ssm_expand"] * d
    h = d_in // cfg["ssm_head_dim"]
    n = cfg["ssm_state"]
    out[("blocks", "ln1")] = (L, d)
    for k, s in {"w_in": (d, 2 * d_in + 2 * n + h), "a_log": (h,), "d_skip": (h,),
                 "dt_bias": (h,), "norm": (d_in,), "w_out": (d_in, d)}.items():
        out[("blocks", "ssm", k)] = (L, *s)
    out[("shared_attn", "ln1")] = (d,)
    out[("shared_attn", "ln2")] = (d,)
    for k, s in attention_shapes(cfg).items():
        out[("shared_attn", "attn", k)] = s
    for k, s in {"wg": (d, f), "wu": (d, f), "wd": (f, d)}.items():
        out[("shared_attn", "mlp", k)] = s
    return out


def run(cfg: dict, tree: dict, tokens, mm: Matmul):
    eps = cfg["rms_norm_eps"]
    every, L = cfg["hybrid_attn_every"], cfg["num_layers"]
    blocks, shared = tree["blocks"], tree["shared_attn"]
    x = embed(tree, tokens)
    for i in range(L):
        x, state = mamba2(blocks, i, x, cfg, mm, eps)
        yield f"state.{i}", state
        if (i + 1) % every == 0 and (i + 1) // every <= L // every:
            x, k, v = attention_block(shared, x, cfg, mm, eps)
            yield f"k.{i // every}", k
            yield f"v.{i // every}", v
            m = shared["mlp"]
            x = x + swiglu(rms_norm(x, shared["ln2"], eps), m["wg"], m["wu"], m["wd"], mm)
    yield "logits", last_logits(tree, x, cfg, mm, eps)


def program_parts(cfg: dict, cache) -> dict:
    """``prefill_step``'s hybrid cache ``(g_states (groups, every, B, H, P,
    N), (g_k, g_v) (groups, B, S, KV, hd), t_states (rest, B, H, P, N) or
    None)`` by part name."""
    g_states, (g_k, g_v), t_states = cache
    groups, every = g_states.shape[:2]
    out = {}
    for g in range(groups):
        for i in range(every):
            out[f"state.{g * every + i}"] = g_states[g, i]
        out[f"k.{g}"], out[f"v.{g}"] = g_k[g], g_v[g]
    for i in range(0 if t_states is None else t_states.shape[0]):
        out[f"state.{groups * every + i}"] = t_states[i]
    return out
